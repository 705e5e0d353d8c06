"""k1_roofline (kernels: `kernels/attention.py` K1): the least time of the
window's self-attention work at the shapes K1 was handed (each device
batch's rows, padded length, heads of the configuration's width, the
fp32 key bias; bytes read and written once) over the profiler's device
time of K1's records, in percent. A run whose trace kept fewer K1
records than the program launched fails."""

from portbench import trace, work

PATTERN = "blockwise_attention"

WINDOW = "traced"


def read(r):
    if r.trace is None or not r.trace["device"]:
        return None
    cfg = r.cfg
    offset = cfg["server"].get("offset", 0)
    bound, launches = 0.0, 0
    for c in r.calls:
        for rows, length in c["batches"]:
            for B, S, N, d, k in work.k1_calls(cfg["family"], cfg["model"],
                                               offset, length, rows):
                bound += k * work.attention_bound_s(B, S, N, d)
                launches += k
    records, seconds = trace.count(r.trace["device"], PATTERN)
    if not launches:
        return None
    if records != launches or records != r.k1_launches:
        raise SystemExit(f"k1_roofline: {records} K1 records in the trace, "
                         f"{launches} calls expected, the program counted "
                         f"{r.k1_launches}")
    return 100.0 * bound / seconds
