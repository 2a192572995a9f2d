"""The card's published peaks and a kernel's roofline bound.

A frozen copy of chip_smoke.py's `bound_ms` with its peaks (NVIDIA H100
SXM data sheet, dense rates, at a 700 W power limit): the least time the
card could take for a kernel's work is the larger of its operations over
the tensor-core rate of their operand types and the bytes of its inputs and
outputs, each moved once, over the memory rate.
"""

from __future__ import annotations

PEAK_FLOPS = {"tf32": 495e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12


def product_kind(*dtypes: str) -> str:
    """The tensor-core rate a product of operands of these types needs:
    bf16 when every operand is bf16, else TF32."""
    return "bf16" if all(t == "bf16" for t in dtypes) else "tf32"


def bound_ms(shape, products, nbytes: int):
    """(ms, "operations" | "bytes") for (N x N x d) products of the kinds in
    `products` at shape (B, h, N, d), moving `nbytes`."""
    B, h, N, d = shape
    ops_s = sum(2 * N * N * d * B * h / PEAK_FLOPS[kind] for kind in products)
    bytes_s = nbytes / PEAK_BYTES
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def flash_bounds(shape, qk: str, v: str) -> dict:
    """The bounds in ms of the flash forward, dq and dkv kernels at `shape`
    with q, k (and dO) of type `qk` and v of type `v` ("f32" or "bf16"):
    the forward moves q, k, v, O and lse; dq moves q, k, v, dO, lse, D and
    dq; dkv moves them and dk, dv."""
    B, h, N, d = shape
    size = {"f32": 4, "bf16": 2}
    t_qk, t_v = size[qk] * B * h * N * d, size[v] * B * h * N * d
    rows = 4 * B * h * N  # an f32 (B, h, N) vector: lse or D
    k = product_kind
    fwd = bound_ms(shape, [k(qk, qk), k(v, v)], 3 * t_qk + t_v + rows)[0]
    args = 2 * t_qk + t_v + t_qk + 2 * rows  # q, k, v, dO, lse, D
    dq = bound_ms(shape, [k(qk, qk), k(qk, v), k(qk, qk)], args + t_qk)[0]
    dkv = bound_ms(shape, [k(qk, qk), k(v, qk), k(qk, qk), k(qk, qk)], args + t_qk + t_v)[0]
    return {"fwd": fwd, "dq": dq, "dkv": dkv, "pair": dq + dkv}
