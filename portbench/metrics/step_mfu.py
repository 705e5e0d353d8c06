"""step_mfu (model step): the least device time of the window's useful
work at the chip's peaks (the text model's product FLOPs at each pair's
true length at the bf16 peak, the backbone's integer operations at the
int8 peak) over the untraced window's seconds, in percent. Padding and the rows a
server repeats to fill a batch are not counted."""

from portbench import work


def read(r):
    if not r.calls:
        return None
    cfg = r.cfg
    fam, m, vis = cfg["family"], cfg["model"], cfg["visual"]
    offset = cfg["server"].get("offset", 0)
    flops = sum(work.TEXT_FLOPS[fam](int(L), m, offset)
                for c in r.calls for L in c["lengths"])
    ops = r.pairs * work.resnet_ops(vis["layers"], vis["crop"])
    least = flops / work.PEAK_BF16 + ops / work.PEAK_INT8
    return 100.0 * least / r.window_s
