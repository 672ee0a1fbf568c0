"""train_clips_per_s: clips of every step finished in the window over the
window's seconds (host clock, from the window's start to the last step the
host saw finish)."""


def read(ctx):
    w = ctx.window
    if w.kind != "train" or not w.records:
        return None
    return sum(r["clips"] for r in w.records) / w.elapsed
