"""visual_ms_per_kpair (visual half: `data/images.py`, `models/resnet.py`):
from each call's start to the moment the device finished preprocessing
and the backbone, by two CUDA events on the device's timeline (no
synchronise is added to the served path), summed over the untraced
window, per 1000 pairs."""


def read(r):
    if not r.pairs:
        return None
    return sum(c["visual_s"] for c in r.calls) / r.pairs * 1e6
