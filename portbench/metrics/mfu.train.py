"""A train step's model FLOPs (forward, and backward at twice it; no
recompute) over the window's seconds per step at the card's bf16 peak,
percent."""

from metrics import _roofline


def read(data):
    s = data.get("s_per_step")
    return 100.0 * data["flops_step"] / (s * _roofline.PEAK_FLOPS["bf16"]) if s else None
