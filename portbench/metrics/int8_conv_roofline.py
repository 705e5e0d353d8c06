"""int8_conv_roofline (kernels: `kernels/conv.py` K4, K5): the least time
of each backbone call's identity blocks and stem at ResNet's shapes and
the call's image count over the profiler's device time of the K4 and K5
records, in percent. A run whose trace kept fewer records than the
backbone launches (one stem, every identity block, a call) fails."""

from portbench import trace, work

PATTERNS = ("int8_bottleneck_kernel", "int8_stem_pool_kernel")

WINDOW = "traced"


def read(r):
    if r.trace is None or not r.trace["device"] or not r.calls:
        return None
    vis = r.cfg["visual"]
    layers = vis["layers"]
    bound = sum(sum(work.backbone_kernel_bounds(layers, c["n"],
                                                vis["crop"]).values())
                for c in r.calls)
    want = {PATTERNS[0]: len(r.calls) * sum(n - 1 for n in layers),
            PATTERNS[1]: len(r.calls)}
    seconds = 0.0
    for pat, n in want.items():
        got, s = trace.count(r.trace["device"], pat)
        if got != n:
            raise SystemExit(f"int8_conv_roofline: {got} {pat} records in "
                             f"the trace, {n} launches expected")
        seconds += s
    return 100.0 * bound / seconds
