"""On-card smoke run of the PyTorch port (vaevar_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure raises, so the script
exits nonzero without its last line:
1. device: a CUDA device is required; prints its name and power limit;
2. build: compiles the CUDA kernels from csrc/ (prints the seconds);
3. kernel against its plain PyTorch version on the card: small f32 shapes
   with ragged tiles (atol 1e-4 on O and lse), the production shape
   (1, 6, 16200, 192) in bf16 and with f32 q/k and bf16 v, the dtypes the
   rope stage hands the kernel, against the plain version in f32 on the same
   inputs (atol 2e-2 on O, 1e-3 on lse); median times of both;
4. the port's model on the card (kernel path) against the same model on the
   CPU (plain path) at a micro size, f32, atol 1e-4;
5. the main path: the README's vae4dvar cycle through
   vaevar_tpu_torch.run_da at full width (0.25 deg FORECAST_025 advance at
   721x1440, VAE decoder at 128x256, Nit 4), 2 cycles after the 8-step
   spin-up, random weights from the seed. Checks the kernel launch count,
   finite analyses, the cost decrease and the on-disk state.
The second-to-last line is a JSON record of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

START = "2022-01-01 00:00:00"
END = "2022-01-01 12:00:00"  # two 6 h cycles
MAIN_ARGS = ["--da_mode", "vae4dvar", "--fast_init", "--grid", "721x1440",
             "--solver_grid", "128x256", "--Nit", "4", "--bf16",
             "--start_time", START, "--end_time", END]
SMALL_SHAPES = [(2, 2, 300, 64), (1, 2, 200, 32), (1, 1, 130, 32)]
PROD_SHAPE = (1, 6, 16200, 192)


def phase(name, msg):
    print(f"[chip_smoke] {name}: {msg}", flush=True)


def median_ms(fn, reps=5):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def rand(shape, seed, dtype, scale=1.0):
    import numpy as np
    import torch

    a = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * scale
    return torch.from_numpy(a).cuda().to(dtype)


def check_kernel(fa):
    """Phase 3: kernel against plain version; returns (max err, ms, plain ms)."""
    import torch

    for i, shape in enumerate(SMALL_SHAPES):
        d = shape[-1]
        q = rand(shape, 10 * i, torch.float32, d ** -0.5)
        k, v = rand(shape, 10 * i + 1, torch.float32), rand(shape, 10 * i + 2, torch.float32)
        o, lse = fa.flash_fwd_cuda(q, k, v)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_plain(q, k, v, 128, 128)
        torch.cuda.synchronize()
        eo = (o - o_ref).abs().max().item()
        el = (lse - lse_ref).abs().max().item()
        phase("kernel", f"f32 {shape}: max|dO| {eo:.3g} max|dlse| {el:.3g} (atol 1e-4)")
        if not (eo <= 1e-4 and el <= 1e-4):
            raise AssertionError(f"kernel disagrees with plain version at {shape}")

    d = PROD_SHAPE[-1]
    worst, timing = 0.0, None
    for qk_dt, v_dt in ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16)):
        q = rand(PROD_SHAPE, 1, torch.float32, d ** -0.5).to(qk_dt)
        k = rand(PROD_SHAPE, 2, torch.float32).to(qk_dt)
        v = rand(PROD_SHAPE, 3, torch.float32).to(v_dt)
        o, lse = fa.flash_fwd_cuda(q, k, v)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), 1024, 1024)
        torch.cuda.synchronize()
        eo = (o.float() - o_ref).abs().max().item()
        el = (lse - lse_ref).abs().max().item()
        tag = f"q/k {str(qk_dt)[6:]} v {str(v_dt)[6:]}"
        phase("kernel", f"{tag} {PROD_SHAPE}: max|dO| {eo:.3g} (atol 2e-2) "
              f"max|dlse| {el:.3g} (atol 1e-3)")
        if not (eo <= 2e-2 and el <= 1e-3):
            raise AssertionError(f"kernel disagrees with plain version ({tag})")
        worst = max(worst, eo)
        # in turns: plain, kernel, kernel, plain
        runs = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = (fa.flash_fwd_cuda if which == "kernel"
                  else lambda *a: fa.flash_attention_plain(*a, 1024, 1024))
            runs[which].append(median_ms(lambda: fn(q, k, v)))
        kern, plain = (statistics.mean(runs[w]) for w in ("kernel", "plain"))
        phase("kernel", f"{tag} {PROD_SHAPE}: kernel {kern:.3f} ms "
              f"({runs['kernel'][0]:.3f}/{runs['kernel'][1]:.3f}), plain {plain:.3f} ms "
              f"({runs['plain'][0]:.3f}/{runs['plain'][1]:.3f}); medians of 5, CUDA events")
        if qk_dt == torch.float32:  # the dtypes the main path hands the kernel
            timing = (kern, plain)
    return worst, timing[0], timing[1]


def check_model():
    """Phase 4: micro rope model with a flash stage, card against CPU."""
    import numpy as np
    import torch

    from vaevar_tpu_torch import config as cfgs
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.utils.fast_init import fast_init

    cfg = cfgs.micro_config(img_size=(32, 64), flash_min_seq=16, enc_dim=32,
                            embed_dim=64, lg_heads=(2,))  # LG head dim 32
    model = fast_init(LGUnet(cfg), seed=3).eval()
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 69, 32, 64), dtype=np.float32))
    with torch.no_grad():
        y_cpu = model(x)
        y_gpu = model.cuda()(x.cuda()).cpu()
    err = (y_gpu - y_cpu).abs().max().item()
    phase("model", f"micro rope LGUnet card vs CPU: max|d| {err:.3g} (atol 1e-4), "
          f"finite {bool(torch.isfinite(y_gpu).all())}")
    if not (err <= 1e-4 and torch.isfinite(y_gpu).all()):
        raise AssertionError("model on the card disagrees with the CPU path")


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    phase("device", f"{kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi, flush=True)

    from vaevar_tpu_torch import config as cfgs
    from vaevar_tpu_torch import run_da
    from vaevar_tpu_torch.ops import _build
    from vaevar_tpu_torch.ops import flash_attn as fa

    path, secs = _build.build("flash_fwd")
    phase("build", f"{path.name} in {secs:.2f} s" + (" (reused)" if secs == 0 else ""))

    max_err, ms, plain_ms = check_kernel(fa)
    check_model()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as work:
        fa.flash_fwd_launches = 0
        t0 = time.perf_counter()
        da = run_da.main(MAIN_ARGS + ["--work_dir", work])
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = fa.flash_fwd_launches
        files = sorted(os.listdir(da.work_dir))
    peak = torch.cuda.max_memory_allocated()

    n_cycles = len(da.cycle_log)
    want = (da.cfg.init_lag + n_cycles) * cfgs.FORECAST_025.lg_depths[0]
    phase("main", f"{n_cycles} cycles in {total:.2f} s; spin-up "
          f"{da.timings['spin_up_s']:.2f} s; cycles "
          + ", ".join(f"{s:.2f}" for s in da.timings["cycle_s"])
          + f" s; peak memory {peak / 2**30:.2f} GiB; flash launches {launches}")
    if n_cycles != 2 or launches != want:
        raise AssertionError(f"{n_cycles} cycles, {launches} flash launches; want 2, {want}")
    decreased = False
    for c in da.cycle_log:
        if not (c["xa_finite"] and c["xb_next_finite"]):
            raise AssertionError(f"non-finite analysis or background at {c['time']}")
        j = [b + o for b, o in zip(c["jb"], c["jo"])]
        # the zoom linesearch's approximate-decrease test (Hager-Zhang) lets a
        # step raise J by up to 1e-6 |J| (optax approx_dec_rtol)
        if j[-1] > j[0] + 1e-6 * abs(j[0]) * c["n_iters"][-1]:
            raise AssertionError(f"J rose over the solve at {c['time']}: {j}")
        decreased |= j[-1] < j[0]
        phase("main", f"cycle {c['time']}: J {j[0]:.6g} -> {j[-1]:.6g}, "
              f"iterations {c['n_iters']}, evals {c['n_evals']}")
    if not decreased:
        raise AssertionError("the solve lowered J in no cycle")
    need = {"xb.npy", "current_time.txt", "bg_wrmse.npy", "ana_wrmse.npy",
            "bg_bias.npy", "ana_bias.npy", "bg_mse.npy", "ana_mse.npy"}
    if not need <= set(files):
        raise AssertionError(f"missing from the work dir: {sorted(need - set(files))}")

    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "vaevar_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "vaevar_tpu/ops/pallas_attn.py:47",
        "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    sys.exit(main())
