#!/usr/bin/env python
"""Convert the JAX package's orbax checkpoints to the PyTorch port's.

    python scripts/orbax_to_torch.py {forecast,flow,vae} ckpt_dir out.pt \
        [--config training_options.yaml] [--micro]

Reads an orbax tree that this repository's JAX side wrote and writes the
port checkpoint (a torch state_dict under the reference key names) that
`python -m vaevar_tpu_torch.run_da` takes as --forecast_ckpt, --flow_ckpt or
--vae_ckpt, through vaevar_tpu_torch/utils/port_jax.py:
- forecast / flow: an LGUnet tree, `{"params": ...}` or bare, as
  scripts/convert_ckpt.py writes and run_train_forecast.py saves as
  `params_latest`;
- vae: a full VAE tree (`{"params": {"enc": ..., "dec": ...}}`, what
  run_train_vae.py and scripts/convert_ckpt.py write) gives the full VAE
  state_dict, a decoder-only tree the decoder's.
The architecture comes from the same presets and --config as
`python -m vaevar_tpu_torch.convert_ckpt`. This script needs jax and orbax
(it runs where the JAX package runs); the port and its GPU host need
neither.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def state_dict_from_tree(kind: str, tree, cfg_yaml: dict | None = None,
                         micro: bool = False) -> dict:
    """An orbax tree (numpy leaves) -> the port state_dict for `kind`."""
    from vaevar_tpu_torch.convert_ckpt import model_config
    from vaevar_tpu_torch.utils import port_jax

    cfg = model_config(kind, cfg_yaml, micro)
    if kind != "vae":
        return port_jax.lgunet_state_dict_from_flax(tree, cfg)
    enc_cfg, dec_cfg = cfg
    params = tree.get("params", tree)
    if "enc" in params and "dec" in params:
        return port_jax.vae_state_dict_from_flax(params, enc_cfg, dec_cfg)
    return port_jax.lgunet_state_dict_from_flax(params, dec_cfg)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("kind", choices=["forecast", "flow", "vae"])
    p.add_argument("src", help="orbax checkpoint directory")
    p.add_argument("out", help="output port checkpoint file")
    p.add_argument("--config", default=None,
                   help="reference training_options.yaml (forecast/flow "
                        "architectures; default: the presets)")
    p.add_argument("--micro", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    import jax
    import numpy as np

    # host work only: never touch (or wait for) an accelerator backend
    jax.config.update("jax_platforms", "cpu")

    from vaevar_tpu.train import checkpoint as orbax_ckpt
    from vaevar_tpu_torch.train import checkpoint as ckpt

    cfg_yaml = None
    if args.config:
        import yaml

        with open(args.config) as f:
            cfg_yaml = yaml.safe_load(f)

    tree = jax.tree.map(np.asarray, orbax_ckpt.restore(args.src))
    sd = state_dict_from_tree(args.kind, tree, cfg_yaml, micro=args.micro)
    ckpt.save(args.out, sd)
    n = sum(v.numel() for v in sd.values())
    print(f"converted {args.kind}: {args.src} -> {os.path.abspath(args.out)} "
          f"({len(sd)} tensors, {n / 1e6:.1f}M params)")


if __name__ == "__main__":
    main()
