"""Convert reference PyTorch checkpoints (.pth) to the port's checkpoints.

    python -m vaevar_tpu_torch.convert_ckpt {forecast,flow,vae} src.pth out \
        [--config training_options.yaml] [--micro]

The port's counterpart of scripts/convert_ckpt.py, with its CLI. A reference
user holds torch state_dict files for the three model roles the DA engine
loads (da_4dvar.py:552-603): the 0.25 deg forecast model (new-gen
`LGUnet_all_1`, wrapped as `{"model": {"lgunet_all": sd}}`), the 1.4 deg flow
model (old-gen `LGUnet_all`, wrapped as `{"model": sd}`) and the VAE (a bare
`VAE_lr` state_dict). The port keeps the reference key names, so conversion
unwraps the file (`train/checkpoint.py::reference_state_dict`: wrappers,
`module.` prefixes, logvar buffers), loads it strictly into the port model of
that kind (a file of another architecture fails), and writes the model's
state_dict as a port checkpoint for run_da's `--forecast_ckpt`,
`--flow_ckpt` and `--vae_ckpt` (the VAE whole: run_da takes its decoder).

Without --config the architecture presets are assumed (FORECAST_025 /
FLOW_140 / VAE_ENCODER + VAE_DECODER; with --micro the micro configs at
their default 16x32 grid, as the JAX script's); pass the reference's
training_options.yaml (forecast/flow) for another architecture. The
conversion is host work: it touches no device.
"""

from __future__ import annotations

import argparse
import os
import time


def lgunet_block_from_yaml(cfg: dict) -> dict:
    """Dig the lgunet params block out of a reference training_options.yaml.

    Both shipped layouts: the 0.25deg forecast yaml nests it at
    model.params.sub_model.lgunet_all (da_4dvar.py:555) and the flow yaml
    at model.network_params (:577)."""
    m = cfg.get("model", cfg)
    for path in (("params", "sub_model", "lgunet_all"), ("network_params",)):
        node = m
        for key in path:
            node = node.get(key) if isinstance(node, dict) else None
            if node is None:
                break
        if isinstance(node, dict) and "inchans_list" in node:
            return node
    raise SystemExit(
        "could not locate an lgunet params block in the yaml "
        "(expected model.params.sub_model.lgunet_all or "
        "model.network_params)"
    )


def model_config(kind: str, cfg_yaml: dict | None = None, micro: bool = False):
    """The architecture of a checkpoint kind: an LGUnetConfig for forecast
    and flow, the (encoder, decoder) pair for vae (scripts/convert_ckpt.py
    :59-79)."""
    from vaevar_tpu_torch import config as cfgs

    if kind == "vae":
        # the VAE architecture is fixed by nf_model/parameters0_old.yaml
        return cfgs.micro_vae_configs() if micro else (cfgs.VAE_ENCODER, cfgs.VAE_DECODER)
    attn = "rope" if kind == "forecast" else "relbias"
    if cfg_yaml is not None:
        return cfgs.LGUnetConfig.from_reference_dict(
            lgunet_block_from_yaml(cfg_yaml), attn_type=attn)
    if micro:
        return cfgs.micro_config(attn_type=attn)
    return cfgs.FORECAST_025 if kind == "forecast" else cfgs.FLOW_140


def convert(kind: str, state_dict: dict, cfg_yaml: dict | None = None,
            micro: bool = False):
    """state_dict (already unwrapped) -> the port model for `kind` with
    those weights, loaded strictly (torch.nn.Module on the CPU)."""
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.models.vae import VAE

    cfg = model_config(kind, cfg_yaml, micro)
    model = VAE(*cfg) if kind == "vae" else LGUnet(cfg)
    model.load_state_dict(state_dict, strict=True)
    return model


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("kind", choices=["forecast", "flow", "vae"])
    p.add_argument("src", help="reference torch checkpoint (.pth)")
    p.add_argument("out", help="output port checkpoint file")
    p.add_argument("--config", default=None,
                   help="reference training_options.yaml (forecast/flow "
                        "architectures; default: the presets)")
    p.add_argument("--micro", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    import torch

    from vaevar_tpu_torch.train import checkpoint as ckpt

    cfg_yaml = None
    if args.config:
        import yaml

        with open(args.config) as f:
            cfg_yaml = yaml.safe_load(f)

    t0 = time.perf_counter()
    # a reference training checkpoint pickles more than tensors (optimizer
    # state, arguments), hence weights_only=False: convert trusted files only
    obj = torch.load(args.src, map_location="cpu", weights_only=False)
    sd = ckpt.reference_state_dict(obj)
    del obj
    model = convert(args.kind, sd, cfg_yaml, micro=args.micro)
    ckpt.save(args.out, model.state_dict())
    n = sum(p.numel() for p in model.parameters())
    print(f"converted {args.kind}: {len(sd)} torch tensors -> "
          f"{os.path.abspath(args.out)} ({n / 1e6:.1f}M params) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


if __name__ == "__main__":
    main()
