#!/usr/bin/env bash
# NMC VAE training of the PyTorch port: scripts/train_vae.sh's flags, run
# through `python -m vaevar_tpu_torch.run_train_vae`. Other flags pass
# through "$@"; for data-parallel training over N GPUs run the module under
# `python -m torch.distributed.run --nproc_per_node N` with --mesh N.
set -euo pipefail
cd "$(dirname "$0")/.."

python -m vaevar_tpu_torch.run_train_vae \
  --sigma 2.0 \
  --lr 1e-4 \
  --epochs 5 \
  "$@"
