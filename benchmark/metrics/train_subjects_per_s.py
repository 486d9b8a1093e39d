"""Subjects trained per second: every volume the window's steps trained,
over the whole window (first dispatch to the drain's end), host clock."""


def read(ctx):
    if not ctx["steps"] or ctx["window_s"] <= 0:
        return None
    return ctx["steps"] * ctx["batch"] / ctx["window_s"]
