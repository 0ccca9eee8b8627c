"""frames_per_s: stream-frames completed over the whole window (every
tick times the streams, over the window's wall seconds; the window ends
with the read of the last call's outputs).  End to end, host clock."""


def read(ctx):
    w = ctx["window"]
    return w.ticks * ctx["n"] / w.seconds
