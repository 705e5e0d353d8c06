"""pairs_per_s: pairs tagged in the window (images in, tags out) over the
window's seconds, host clock."""


def read(r):
    return r.pairs / r.window_s
