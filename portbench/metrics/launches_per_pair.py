"""launches_per_pair (model step, host dispatch): device records (kernels,
copies, sets) of the traced window over the pairs served in it."""

WINDOW = "traced"


def read(r):
    if r.trace is None or not r.trace["device"] or not r.pairs:
        return None
    return len(r.trace["device"]) / r.pairs
