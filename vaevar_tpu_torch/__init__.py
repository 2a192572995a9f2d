"""vaevar_tpu_torch — the PyTorch/CUDA port of vaevar_tpu for one NVIDIA H100.

The JAX package `vaevar_tpu` stays the reference: each module here mirrors
one there (same layouts at the public functions, same numerics up to the
stated tolerances). The flash-attention forward is a hand-written CUDA kernel
(csrc/flash_fwd.cu); everything else is plain PyTorch. Importing this package
imports no JAX.
"""

__version__ = "0.1.0"
