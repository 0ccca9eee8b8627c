"""relock_tick_pct: the share of the window's ticks that ran a bucket
body (the ticks that serve pending streams), from the serving program's
own count of each body's runs a launch (serving program; moves
frames_per_s)."""


def read(ctx):
    w = ctx["window"]
    if not w.runs or not w.ticks:
        return None
    ran = sum(r[i] for r in w.runs for i in ctx["relock_bodies"])
    return 100.0 * ran / w.ticks
