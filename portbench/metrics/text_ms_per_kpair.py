"""text_ms_per_kpair (text model and decode: the server's `predict` and
`models/*`, `nn/*`): of each call's latency, what follows the moment the
device finished the visual half (so the part of `predict` that the visual
half's device work did not cover), summed over the untraced window, per
1000 pairs."""


def read(r):
    if not r.pairs:
        return None
    return sum(c["latency_s"] - c["visual_s"] for c in r.calls) \
        / r.pairs * 1e6
