"""The window's cycles' model FLOPs over their seconds at the card's bf16
peak, percent. Per cycle: each reverse eval a decoder value and gradient
(3 forwards), each jvp probe a forward and its tangent (2), and one
forecast forward; the counts from the cycle log (`n_evals` charged, of
which `n_jvp` jvp probes)."""

from metrics import _roofline


def read(data):
    log = data.get("cycle_log")
    if not log:
        return None
    f = data["model_flops"]
    total = 0
    for c in log:
        evals, jvp = sum(c["n_evals"]), sum(c["n_jvp"])
        total += (3 * (evals - jvp) + 2 * jvp) * f["decoder"] + f["forecast"]
    return 100.0 * total / (data["window_s"] * _roofline.PEAK_FLOPS["bf16"])
