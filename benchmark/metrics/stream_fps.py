"""stream_fps: frames of every stream completed in the window over the
window's seconds (host clock, from the window's start to the last call's
end)."""


def read(ctx):
    w = ctx.window
    if w.kind != "stream" or not w.records:
        return None
    return sum(r["frames"] for r in w.records) / w.elapsed
