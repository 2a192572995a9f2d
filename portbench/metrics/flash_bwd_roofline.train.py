"""The flash backward pair's (dq and dkv kernels) share of its roofline
bound: the two kernels' bounds at the full-grid stage's shape and the
launches' operand types, over their device time per launch, percent."""

from metrics import _roofline


def read(data):
    from devtrace import flash_launches

    t = data.get("trace")
    got = flash_launches(t["kernels"]) if t else {}
    if "dq" not in got or "dkv" not in got or None in got["dq"][2]:
        return None
    (n, s_dq, (qk, v)), (_, s_dkv, _) = got["dq"], got["dkv"]
    bound = _roofline.flash_bounds(data["flash_shape"], qk, v)["pair"]
    return 100.0 * bound / (1e3 * (s_dq + s_dkv) / n)
