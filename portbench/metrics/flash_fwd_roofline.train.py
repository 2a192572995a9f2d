"""The flash forward kernel's share of its roofline bound: the bound at the
full-grid stage's shape and the launch's operand types (from the kernel's
name in the trace) over the kernel's device time per launch, percent."""

from metrics import _roofline


def read(data):
    from devtrace import flash_launches

    t = data.get("trace")
    got = flash_launches(t["kernels"]).get("fwd") if t else None
    if not got or None in got[2]:
        return None
    n, secs, (qk, v) = got
    return 100.0 * _roofline.flash_bounds(data["flash_shape"], qk, v)["fwd"] / (1e3 * secs / n)
