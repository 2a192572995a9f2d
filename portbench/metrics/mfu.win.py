"""The window's cycles' model FLOPs over their seconds at the card's bf16
peak, percent. Per cycle: each value and gradient (a charged eval that is
not a jvp probe, or an uncharged restore) 3 forwards of the decoder and of
the da_win - 1 flow steps, each jvp probe 2 (a forward and its tangent),
and one forecast forward; the counts from the cycle log (`n_evals`,
`n_jvp`, `n_restore`); no recompute counted (metrics/_flops.py)."""

from metrics import _roofline


def read(data):
    log = data.get("cycle_log")
    if not log:
        return None
    f = data["model_flops"]
    probe = f["decoder"] + (data["da_win"] - 1) * f["flow"]
    total = 0
    for c in log:
        jvp = sum(c["n_jvp"])
        reverse = sum(c["n_evals"]) - jvp + sum(c["n_restore"])
        total += (3 * reverse + 2 * jvp) * probe + f["forecast"]
    return 100.0 * total / (data["window_s"] * _roofline.PEAK_FLOPS["bf16"])
