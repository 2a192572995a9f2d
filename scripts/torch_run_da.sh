#!/usr/bin/env bash
# Cycled DA run of the PyTorch port on one GPU, configuration of record:
# scripts/run_da.sh's flags, run through `python -m vaevar_tpu_torch.run_da`.
#
# The run loops on failure and RESUMES from the cycler's on-disk cursor
# (xb.npy + current_time.txt), so a restart or a preemption costs at most
# one cycle. Extra flags (--data_dir, --work_dir, ...) pass through "$@".
set -uo pipefail
cd "$(dirname "$0")/.."

MAX_RETRIES="${MAX_RETRIES:-20}"
attempt=0
while :; do
  python -m vaevar_tpu_torch.run_da \
    --da_mode vae4dvar \
    --da_win 1 \
    --Nit 4 \
    --obs_std 0.005 \
    --obs_type column_random_0001 \
    --modify_tp 2 \
    --scale_factor 2.0 \
    --q_type 1 \
    --obs_coeff 1.0 \
    --filter_coeff 0.1 \
    --start_time "2022-01-01 00:00:00" \
    --end_time   "2023-01-01 12:00:00" \
    --vae_ckpt   "${VAE_CKPT:-}" \
    --flow_ckpt  "${FLOW_CKPT:-}" \
    --forecast_ckpt "${FORECAST_CKPT:-}" \
    "$@" && break
  attempt=$((attempt + 1))
  if [ "$attempt" -ge "$MAX_RETRIES" ]; then
    echo "run_da failed ${MAX_RETRIES} times; giving up" >&2
    exit 1
  fi
  echo "run_da exited nonzero; resuming from checkpoint (attempt ${attempt})" >&2
  sleep 30
done
