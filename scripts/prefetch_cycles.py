"""Steady DA cycles with and without the cycler's obs prefetch thread, on
one GPU.

    python3 scripts/prefetch_cycles.py [--cycles 3] [--configs readme,real_obs]

For each configuration (the README's vae4dvar 3D-Var cycle at full width,
chip_smoke.py's MAIN_ARGS, and the same cycle on real observations,
`--obs_type real_simu --use_eval`, REAL_OBS_ARGS) it runs
vaevar_tpu_torch.run_da for --cycles 6 h cycles after the 8-step spin-up
four times in one process, in the order prefetch, --no_prefetch,
--no_prefetch, prefetch, so that neither mode always runs first. Prints one
JSON line per run (per cycle: seconds, obs_s on the worker, obs_wait_s,
solve_s and the station obs' truth, gridding and copy + augment + QC
seconds; spin-up and model seconds; peak memory) and one per pair of runs
(chip_smoke.compare_runs: obs equal, bitwise, worst norm-rel difference),
the two --no_prefetch runs being the serial loop's repeat.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

CYCLE_KEYS = ("seconds", "obs_s", "obs_wait_s", "solve_s", "truth_s", "grid_s", "aug_qc_s")


def end_time(cycles: int) -> str:
    return f"2022-01-0{1 + 6 * cycles // 24} {6 * cycles % 24:02d}:00:00"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cycles", type=int, default=3)
    p.add_argument("--configs", type=str, default="readme,real_obs")
    args = p.parse_args(argv)

    import torch

    from vaevar_tpu_torch.ops import _build
    from vaevar_tpu_torch.ops import flash_attn as fa

    if not torch.cuda.is_available():
        raise SystemExit("prefetch_cycles: no CUDA device available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    _build.build_all(["flash_fwd", "flash_bwd"])

    def emit(rec):
        rec["card"] = smi
        print(json.dumps(rec), flush=True)

    base = chip_smoke.FULL_WIDTH + ["--end_time", end_time(args.cycles)]
    configs = {"readme": base, "real_obs": base + ["--obs_type", "real_simu", "--use_eval"]}
    for name in args.configs.split(","):
        runs = []
        for prefetch in (True, False, False, True):
            argv = configs[name] + ([] if prefetch else ["--no_prefetch"])
            da, counts, total, peak, outs = chip_smoke.run_da_phase(fa, argv)
            emit({"config": name, "prefetch": da.prefetch_obs, "run": len(runs),
                  "total_s": total, "models_s": da.timings["models_s"],
                  "spin_up_s": da.timings["spin_up_s"], "peak_gib": peak,
                  "launches": counts,
                  "cycles": [{k: c[k] for k in CYCLE_KEYS if k in c} | {"time": c["time"]}
                             for c in da.cycle_log]})
            runs.append((SimpleNamespace(cycle_log=da.cycle_log), outs))
            del da  # its models, before the next run's peak is read
            gc.collect()
            torch.cuda.empty_cache()
        for i, j, what in ((0, 1, "prefetch vs serial"), (3, 2, "prefetch vs serial"),
                           (1, 2, "serial repeat"), (0, 3, "prefetch repeat")):
            obs_equal, bitwise, worst = chip_smoke.compare_runs(runs[i], runs[j])
            emit({"config": name, "compare": what, "runs": [i, j], "obs_equal": obs_equal,
                  "bitwise": bitwise, "worst_norm_rel": worst})
        del runs
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
