"""device_idle (device, H100): 1 - the union of the device records'
intervals over the traced window's seconds, in percent."""

from portbench import trace

WINDOW = "traced"


def read(r):
    if r.trace is None or not r.trace["device"]:
        return None
    return 100.0 * (1.0 - trace.busy_ns(r.trace["device"]) / 1e9
                    / r.window_s)
