"""The run-time check that no JAX is loaded in the benchmark's process.

The program measured is the PyTorch port `vaevar_tpu_torch`; the JAX
package `vaevar_tpu` beside it, and JAX itself, must not run here. Modules
are compared by their top-level name (the part before the first dot) as a
whole, so `vaevar_tpu_torch` is allowed and `vaevar_tpu.x` is not.
"""

from __future__ import annotations

import sys

REFUSED = frozenset({"jax", "jaxlib", "flax", "optax", "vaevar_tpu"})


def refused_modules(names) -> list[str]:
    """The names among `names` whose top-level name is refused, sorted."""
    return sorted(n for n in names if n.split(".", 1)[0] in REFUSED)


def check_no_jax():
    """Raise SystemExit naming the modules found, if any is loaded."""
    found = refused_modules(list(sys.modules))
    if found:
        print("portbench: refused modules are loaded: " + ", ".join(found), file=sys.stderr)
        raise SystemExit(3)
