"""Entry points of the port, the counterparts of vaevar_tpu/cli.py's four
console wrappers: each runs a module's `main` with the process's arguments.

The port's CLIs are modules of the package, run as
`python -m vaevar_tpu_torch.run_da` (and `.run_train_vae`,
`.run_train_forecast`, `.convert_ckpt`); these functions are the same
programs for a caller that imports them. The console scripts of
pyproject.toml stay the JAX package's.
"""

from __future__ import annotations


def da_main():
    from vaevar_tpu_torch import run_da

    run_da.main()


def train_vae_main():
    from vaevar_tpu_torch import run_train_vae

    run_train_vae.main()


def train_forecast_main():
    from vaevar_tpu_torch import run_train_forecast

    run_train_forecast.main()


def convert_ckpt_main():
    from vaevar_tpu_torch import convert_ckpt

    convert_ckpt.main()
