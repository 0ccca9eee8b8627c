"""host_call_ms: the harness's span around each ``run_scan`` or
``step_auto`` call until it returns, summed over the window's calls and
divided by their number (serving entry; moves frames_per_s)."""


def read(ctx):
    calls = ctx["window"].calls
    if not calls:
        return None
    return 1e3 * sum(c1 - c0 for c0, c1, _, _ in calls) / len(calls)
