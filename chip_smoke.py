"""On-card smoke run of the PyTorch port (vaevar_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure raises, so the script
exits nonzero without its last line:
1. device: a CUDA device is required; prints its name and power limit;
2. build: compiles the CUDA kernels from csrc/, one nvcc per source, all
   started together (prints the seconds of each);
3. forward kernel against its plain PyTorch version on the card: small f32
   shapes with ragged tiles (atol 1e-4 on O and lse), the production shape
   (1, 6, 16200, 192) in bf16 and with f32 q/k and bf16 v, the dtypes the
   rope stage hands the kernel, against the plain version in f32 on the same
   inputs (atol 2e-2 on O, 1e-3 on lse); two launches bitwise equal; median
   times of the kernel, the plain version and the library call that
   computes the same function (`library_fwd`), in turns;
4. backward kernels (dq, dkv) against their plain versions: the same small
   f32 shapes, and the production shape with f32 q/k/dO and bf16 v (the
   main path's) and in bf16, against the plain backward in f32 on the same
   inputs; a tolerance per gradient, relative to its largest entry (see
   BWD_TOL); the dq kernel's CTA, registers and spills at head dim 192
   (`dq_build_report`); two launches bitwise equal; median times of both
   with their share of the bound, and of the whole backward (D, dq and dkv)
   beside the library's backward, which computes the pair's function in one
   call (`library_bwd_fn`);
5. the port's model on the card (kernel path) against the same model on the
   CPU (plain path) at a micro size, f32: the forward (atol 1e-4), then one
   Possloss train step with remat (loss and gradients);
5b. pinned: JAX's production-geometry golden on the card. VAE_DECODER,
   FLOW_140 and FORECAST_025 built by run_da.build_models with --fast_init
   from seeds 0, 1 and 2 (run_da's roles) must carry JAX's draw: the sha256
   of every parameter equals tests/goldens/torch_fast_init_sha256.json.
   Then tests/test_torch_prod_pinned.py's construction (JAX's
   tests/test_prod_geometry_pinned.py: that decoder in f32, latent
   (1, 32, 128, 256), free_0010 obs, one_step_da with nit 1 x 2 L-BFGS
   iterations) runs on the card under torch.profiler; its
   summary must match tests/goldens/prod_geometry_pinned.json within JAX's
   tolerances (relative 5e-3 on the six scalars, 1e-2 on the increment
   probe). Prints each relative error, the build, hash and solve seconds,
   the peak memory, the trace's size and its top device operations. No
   flash launch (VAE_DECODER is relbias);
6. the DA path: the README's vae4dvar cycle through vaevar_tpu_torch.run_da
   at full width (0.25 deg FORECAST_025 advance at 721x1440, VAE decoder at
   128x256, Nit 4), 2 cycles after the 8-step spin-up, random weights from
   the seed. Checks the forward kernel's launch count, finite analyses, the
   cost decrease, the on-disk state, and that the solve captured its CUDA
   graphs once and replayed every value+grad probe (da/graphs.py; the
   jvp probes stay eager);
6b. the window path: the same cycle as 4D-Var with --da_win 6 (FLOW_140
   inside J at 128x256, block and step remat, the linesearch `auto`
   resolves to jvp-zoom), one cycle from the truth (--init_tp 1, no
   spin-up), Nit 1. Checks the launches (4 forward: the advance; the window cost
   runs no flash op), the resolved linesearch, the cost decrease, finite
   fields and the on-disk state; prints the seconds of the cycle, of its obs
   preparation and of the solve, the per-segment iterations, charged evals,
   jvp probes and gradient restores, and the peak device memory. Then, at
   micro size in f32 on the card, one window solve (da_win 3) with zoom and
   with jvp-zoom: equal iteration and eval counts and analyses within
   norm-relative 1e-5, and the jvp slope against grad . u;
7. the training path: FORECAST_025 at 721x1440, batch 1, bf16, remat,
   Possloss, random weights from the seed, the trainer CLI's lr and AdamW:
   3 train steps through make_forecast_train_step on one synthetic ERA5
   pair, then one eval step. Checks finite and falling losses, a finite
   nonzero gradient at every LG stage-0 qkv, and the launch counts (8
   forward, 4 dq, 4 dkv per train step; 4 forward for the eval step);
   prints seconds per step and peak device memory (the inputs, step 1's
   gradient norms and the parameters after step 2 are kept, off the steps'
   clock, for phase 18);
8. the trainer CLI on the card (run_train_forecast --micro --grid 32x64):
   2 steps with validation and a checkpoint, then a second run that resumes
   at the saved step;
9. record: the configuration of record (scripts/run_da.sh's flags) with its
   inputs. Writes a reference-layout ERA5 store at 721x1440 from the
   synthetic source (the spin-up frame at start - 48 h and the cycle's
   truth) and checks that it reads back bit for bit; writes random-weight
   checkpoints (FORECAST_025 as a wrapped reference .pth with `module.`
   prefixes and logvar buffers, the full VAE as a bare .pth), converts both
   with `python -m vaevar_tpu_torch.convert_ckpt`'s main, and writes FLOW_140
   as a port params_latest; then runs vaevar_tpu_torch.run_da with
   run_da.sh's flags, the three checkpoints, no --fast_init and the store
   (--data_layout reference), cut to one 6 h cycle after the 8-step
   spin-up. Checks the store's native reader, (8 + 1) x 4 = 36 forward
   launches and no backward one, finite fields, the cost decrease and the
   on-disk state; prints the seconds of the conversions, of the model loads,
   of a frame read through the native pool, with np.load and through
   LocalNpyStore (median of 3, files just written), of the spin-up and the
   cycle, and the peak device memory.
10. vae_train: the NMC VAE trainer (train/vae_trainer.py). A micro f32 step
   (run_train_vae --micro's configs at 32x64) on the card against the CPU
   with a fixed noise (loss rel 1e-5, gradients 1e-3 x max|grad|); 3 steps
   of train_vae at run_train_vae's defaults (FLOW_140 4 times without
   gradient, VAE_ENCODER + VAE_DECODER, batch 8 at 128x256, bf16, remat,
   Adam lr 1e-4, sigma 2) on one NMC batch: loss finite, the loss at one
   fixed noise draw lower after the steps than before, more than half the
   parameters moved by lr/2 or more and none by more than 4 lr, no flash
   launch; seconds per step (the first apart), peak memory (step 1's
   gradient norms and the parameters after step 2 are kept, off the steps'
   clock, for phase 17), and one
   more step split into the NMC sample, forward + backward and Adam; then
   run_train_vae --micro trained, resumed, and its vae_latest read by
   run_da --micro --vae_ckpt;
11. sc4dvar: the CVT increment (da/cvt.py) at 128x256 on the card against
   the CPU in f32 (norm-rel 1e-5), the synthetic B calibrated on the card;
   the README's cycle as --da_mode sc4dvar
   at full width for 2 cycles after the 8-step spin-up, on the calibrated
   synthetic B (no dataset/bq_info_lr here): 40 forward launches, no
   decoder built, the synthetic-B WARNING on stderr, at most 5 L-BFGS
   iterations per segment, J lowered, finite fields; prints the resolved
   linesearch, spin-up and cycle seconds and peak memory.
12. real_obs: the README's cycle with real observations (--obs_type real_simu
   --use_eval: 2000 synthetic stations gridded onto the 204 observation-level
   channels, the truth augmented on the card, QC, the 20 % holdout, the
   full-grid cost with the augmentation inside J) at full width for 2 cycles
   after the 8-step spin-up, Nit 2: 40 forward launches and no backward one,
   `auto` -> jvp-zoom, J lowered, finite fields, obs gridded and kept by QC
   in every cycle, error_obs.npy with 204 entries per cycle; prints the
   spin-up and cycle seconds, the obs preparation split into truth reads,
   gridding and copy + augment + QC, the solve seconds and peak memory.
   Every run_da phase runs the obs prefetch thread (the default); here the
   same 2 cycles run first with --no_prefetch (the serial loop), and the two
   runs, each with models of its own build, must have received equal obs in
   each cycle (the cycle log's checksums of yo, H and gt, and the obs
   counts) and agree bit for bit on
   the rest of the cycle log, the metric dumps and xb.npy (two serial runs
   repeat bit for bit on the card: scripts/prefetch_cycles.py); each run's
   cycle, obs and obs-wait seconds and peak memory are printed. Then
   one full-width prepbufr cycle (da_win 1, Nit 2, from the truth: 4 launches), one
   full-width free_run cycle with --forecast_eval --forecast_eval_steps 2
   (12 launches, forecast_wrmse.npy), a micro f32 real-obs window solve
   (da_win 3) card vs CPU (norm-rel 1e-5), and interpolation at micro size.
   The prepbufr and free_run runs take the prefetch run's models
   (`shared_builds`: the same roles from the same seed, bit for bit the
   same weights).
13. osse: the OSSE (vaevar_tpu_torch/osse.py) on the card, in a process of
   its own (`--osse-worker`) started with phase 9 and running beside phases
   9-10, its output printed here: the micro VAE
   trained 120 epochs on SharedModeEra5's NMC errors (its loss must fall
   below 0.35 of its first value), then free_run, vae4dvar, sc4dvar and
   the da_win 3 window cycled for 2 days at 32x64, all with torch's
   deterministic algorithms (so they repeat bit for bit from run to run);
   prints the first and last loss, the trained decoder's checksum, the
   seconds of the training and of each run, and every ratio of
   tests/test_osse_science.py beside its bound; a missed bound fails.
14. dp: data-parallel training (parallel/mesh.py, DDP). (a) 2 ranks on the
   one card over gloo (nccl refuses two ranks on one device), in 2 worker
   processes (`--dp-worker`): FORECAST_025 at 721x1440, b1 per rank, bf16,
   remat, Possloss, 2 steps; prints seconds per step, peak memory and the
   launches per rank (8, 4, 4 per step), the all-reduce of the gradients
   alone and its share of the step; the ranks' checksums must be bitwise
   equal. (b) one micro f32 dp=2 step against a dp=1 step on the same
   global batch (loss rel 1e-5, gradients 1e-3 x max|grad|). (c)
   run_train_forecast --mesh 1 through torch.distributed.run with nccl.
15. sd_zoo: SD_attn's general path and the layer zoo (models/zoo.py).
   (a) FORECAST_025-SD: FORECAST_025 with lg_window_size (1, 6, 12) and
   dilated_size (1, 1, 3) (its LG stages 1-2 run 3-D windows with rope3,
   every encoder and decoder window is dilated; LG stage 0 stays the
   full-grid flash stage) at 721x1440, b1, bf16, remat, Possloss, random
   weights from the seed: one forward (4 flash forward launches), 2 train
   steps (8, 4, 4 each) and an eval step (4), the eval loss below the
   first step's, LG stage 1's qkv gradient finite and nonzero; prints
   set-up, forward and step seconds and peak memory. (b) the micro SD
   model card vs CPU in f32 (forward atol 1e-4, one train step's gradients
   1e-3 x max|grad|). (c) every zoo module card vs CPU at micro size in f32
   (outputs atol 1e-4, MoE expert indices equal except at counted
   near-ties), then forward and backward of each at the backbone's widths
   (dim 192, 6 heads, window 6x12, grid 90x180, b1, bf16): finite, seconds
   printed.
16. mesh: the spatially partitioned solve (run_da --mesh SHxSW,
   parallel/mesh.py), its ranks in worker processes (`--mesh-worker`) on
   the one card over gloo. (a) the real_obs phase's configuration cut to
   its first cycle as --mesh 1x2 on 2 ranks, each holding its lon half of
   the (1, 204, 721, 1440) yo and H: rank 0's cycle held to the real_obs
   phase's cycle 1 (equal iterations and evals, Jb, Jo, ana_wrmse,
   bg_wrmse and error_obs within 1e-3 relative), the ranks' lockstep
   digests equal, each rank's yo + H half the single run's, obs counts
   summed to the single run's, 36 forward launches per rank; prints each
   rank's seconds, obs bytes and peak memory beside the real_obs phase's
   runs' (2 cycles, without and with the prefetch: the one without bounds
   a 1-cycle run's peak from above, and so the saving).
   (b) micro --mesh 2x2 (4 ranks) reduced 3D-Var and da_win 3 window cycles
   against single-process runs (the same checks), then in the same ranks
   the tensor-parallel --mesh 2x1x2 (tp 2 x sh 1 x sw 2: the decoder's and
   the flow model's LG stages split over each lon half's 2 tp ranks) for
   the same two cycles (the same checks) and a bf16 3D-Var cycle, whose
   analysis increment is held within norm-relative 1e-3 of one process's
   (JAX's sharded-solve bound). (c) run_da --mesh 1x1x1 through
   torch.distributed.run with nccl, run beside (b). (d) and (e), in 2
   tensor-parallel worker processes (`--tp-worker`, gloo, tp 2) beside
   (a): (d) the production VAE_DECODER (215.9 M, f32, --fast_init seed 0)
   placed at tp 2 on each rank, then tests/test_torch_prod_pinned.py's
   summary with it, held to JAX's pinned golden within JAX's tolerances,
   both ranks' summaries bitwise equal; prints the errors, each rank's
   parameter bytes against the whole model's and its peak. (e) a micro rope
   LGUnet with a flash stage (2 heads of 32 on its full-grid LG stage)
   placed at tp 2, forward and one Possloss train step against the unplaced
   model on the card (atol 1e-4; gradients 1e-3 x max|grad|), each rank's
   flash (fwd, dq, dkv) launches nonzero; a MoEMlp of 8 experts at the LG
   stage's widths (dim 192, 90x180) placed by shard_experts at ep 2 against
   the unplaced module (output rtol 2e-6 + atol 1e-6, losses rtol 1e-6,
   gradients 5e-5 x max|grad|).
17. spatial_train: the VAE trainer's spatial mesh (run_train_vae --mesh
   DPxSHxSW: LGUnet.partition, the halo exchanges of parallel/spatial.py,
   the gradients summed over the ranks), its ranks in worker processes
   (`--spatial-worker`) on the one card over gloo, started after phase 11,
   running beside phase 12 and joined after phase 13. (a) the micro
   f32 VAE step (run_train_vae --micro's configs with 2 blocks per stage,
   so that halos cross both axes) at --mesh 1x2x2 on 4 ranks against one
   process on the card: loss rel 1e-5, gradients 1e-3 x max|grad|, the
   ranks bitwise equal, halo exchanges on every rank. (b) run_train_vae's
   defaults (FLOW_140, VAE_ENCODER + VAE_DECODER, 128x256, b8, bf16, remat)
   at --mesh 1x1x2 on 2 ranks: 2 train_vae steps on phase 10's batch and
   noise, held to phase 10's first 2 steps (losses, step-1 gradient norms
   per tensor, the parameters after step 2; the tolerances and their
   reasons in check_spatial_train), the ranks bitwise equal, no flash
   launch; prints each rank's peak memory beside the single process's, its
   step seconds, step 2's halo exchanges (count, bytes of one and in all,
   seconds) and the gradient all-reduce alone.
18. spatial_forecast: the forecast trainer's spatial mesh (run_train_forecast
   --mesh DPxSHxSW: window-aligned tiles where an even tile would cut a
   window, `retile` in and out of such a level, the full-grid LG stage run
   whole on every rank through the flash kernels, each rank's share of the
   loss, the gradients summed over the ranks), its ranks in worker
   processes (`--spatial-forecast-worker`) on the one card over gloo,
   started after phase 8, running beside phases 9-11 and joined after
   phase 11. (a) a micro f32 Possloss step (the CPU tests' rope micro at
   16x48, head dims 32 and 64, flash_min_seq 48, so that the full-grid
   stage launches the kernels) at --mesh 1x1x2 on 2 ranks and 2x1x2 on 4
   against one process on the card: loss rel 1e-5, gradients 1e-3 x
   max|grad|, the ranks bitwise equal, each rank's flash launches those of
   one process. (b) FORECAST_025 at 721x1440, b1, bf16, remat, Possloss
   at --mesh 1x1x2 on 2 ranks (each the lon half: the 90x180 level on 96 +
   84 columns): 2 steps on phase 7's inputs and weights, held to phase 7's
   first 2 steps (losses, step-1 gradient norms per tensor, the parameters
   after step 2; check_spatial_train's bf16 tolerances), the ranks bitwise
   equal, (8, 4, 4) flash launches per rank and step; prints each rank's
   peak memory beside phase 7's, its step seconds, each step's exchanges
   by kind (halo rolls, retiles, the stage-0 gather and its backward's
   all-reduce: count, bytes, seconds) and the gradient all-reduce alone.
The main phase also prints cycle 2's obs seconds (on the prefetch worker)
and the seconds the loop waited for them. The smoke runs with the port's
tracing on (utils/trace.py), every phase a span of its name; the report
(seconds per phase, and the total by the smoke's own clock) comes before
the kernels line. The flash launches are the counters `flash.fwd`,
`flash.dq` and `flash.dkv`.
The second-to-last line is a JSON record of the kernels (launches summed
over the DA, window, training, record, VAE-training, sc4dvar, real-obs,
sd_zoo (a), dp, mesh (a), mesh (e) and spatial_forecast (b) paths (all
ranks), each counted from 0; times with the main
path's dtypes, and under "bf16" the all-bf16 ones; each bound from the
function `bound_ms` below); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import atexit
import contextlib
import gc
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

START = "2022-01-01 00:00:00"
END = "2022-01-01 12:00:00"  # two 6 h cycles
FULL_WIDTH = ["--da_mode", "vae4dvar", "--fast_init", "--grid", "721x1440",
              "--solver_grid", "128x256", "--Nit", "4", "--bf16", "--start_time", START]
MAIN_ARGS = FULL_WIDTH + ["--end_time", END]
# The paths beside the main one solve Nit 2 of the README's 4 segments: the
# depth cut that keeps the smoke well inside its time limit.
CUT = ["--Nit", "2"]
# one 6 h cycle of 4D-Var from the truth: the main phase runs the spin-up;
# one segment (its first holds the 6 jvp probes), cut from 2 when the mesh
# phase came in
WINDOW_ARGS = FULL_WIDTH + ["--end_time", "2022-01-01 06:00:00", "--da_win", "6",
                            "--init_tp", "1", "--Nit", "1"]
SMALL_SHAPES = [(2, 2, 300, 64), (1, 2, 200, 32), (1, 1, 130, 32)]
PROD_SHAPE = (1, 6, 16200, 192)
# Backward tolerances, relative to the gradient's largest |entry|, keyed by
# (q/k type, gradient type), against the plain backward in f32:
# - an f32 gradient: the same f32 math summed in another order over up to
#   16200 terms;
# - a bf16 gradient of f32 q/k (dv on the main path): its rounding to bf16,
#   half an ulp (2^-9) and one more where f32 noise crosses a boundary;
# - all-bf16: dS and P^T are rounded to bf16 (2^-9 each) where the f32
#   reference does not round, and cancel in the sums.
BWD_TOL = {("float32", "float32"): 2e-5, ("float32", "bfloat16"): 2 ** -7,
           ("bfloat16", "bfloat16"): 2 ** -6}
# The card's published peaks (H100 SXM data sheet, dense, at 700 W): tensor
# cores in TF32 and bf16, and device memory.
PEAK_FLOPS = {"tf32": 495e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12
LR = 5e-6  # run_train_forecast's default
# scripts/run_da.sh:18-32, the configuration of record, flag for flag; the
# checkpoint paths stand for $VAE_CKPT, $FLOW_CKPT and $FORECAST_CKPT
RECORD_FLAGS = ["--da_mode", "vae4dvar", "--da_win", "1", "--Nit", "4", "--obs_std", "0.005",
                "--obs_type", "column_random_0001", "--modify_tp", "2", "--scale_factor",
                "2.0", "--q_type", "1", "--obs_coeff", "1.0", "--filter_coeff", "0.1",
                "--start_time", "2022-01-01 00:00:00", "--end_time", "2023-01-01 12:00:00"]
# what run_da.sh's "$@" appends here: the store, and the end time cut to one
# 6 h cycle after the spin-up
RECORD_CUT = ["--end_time", "2022-01-01 06:00:00"]
# the real-obs cycle: the README cycle on a synthetic station network
REAL_OBS_ARGS = MAIN_ARGS + ["--obs_type", "real_simu", "--use_eval"] + CUT
# The cycle log's timing fields: everything else in it must agree between
# a run with the obs prefetch thread and one with --no_prefetch.
TIMING_KEYS = {"seconds", "obs_s", "obs_wait_s", "truth_s", "grid_s", "aug_qc_s", "reduce_s",
               "solve_s"}
# one 6 h cycle from the truth (--init_tp 1, no spin-up)
ONE_CYCLE = FULL_WIDTH + ["--end_time", "2022-01-01 06:00:00", "--init_tp", "1"]
TOTAL_STEPS = 200  # run_train_forecast's --steps x --epochs defaults


def phase(name, msg):
    print(f"[chip_smoke] {name}: {msg}", flush=True)


def solve_graph_counts(since=(0, 0, 0, 0)):
    """The 3D-Var solve graphs' captures and replays, the L-BFGS probes and
    the jvp probes among them in this process (utils/trace.py's counters),
    less `since`."""
    from vaevar_tpu_torch.utils import trace

    c = trace.counters()
    return tuple(c.get(k, 0) - s for k, s in zip(
        ("solve.graph_captures", "lbfgs.graph_replays", "lbfgs.probes", "lbfgs.jvp"), since))


def flash_launches(since=(0, 0, 0)):
    """The flash kernels' launches in this process, (fwd, dq, dkv), from
    their counters (utils/trace.py), less `since` (an earlier reading)."""
    from vaevar_tpu_torch.utils import trace

    c = trace.counters()
    return tuple(c.get(f"flash.{k}", 0) - s for k, s in zip(("fwd", "dq", "dkv"), since))


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


def in_turns(**fns):
    """Median CUDA-event ms of each function, in turns: the given order,
    then the reverse (plain, kernel, library, library, kernel, plain);
    returns ({name: mean of its two medians}, {name: the two medians})."""
    runs = {name: [] for name in fns}
    for name in [*fns, *reversed(fns)]:
        runs[name].append(median_ms(fns[name]))
    return {name: statistics.mean(r) for name, r in runs.items()}, runs


def turns_line(means, runs):
    return ", ".join(f"{name} {means[name]:.3f} ms ({r[0]:.3f}/{r[1]:.3f})"
                     for name, r in runs.items()) + "; medians of 5, CUDA events"


def product_kind(*dtypes):
    """The tensor-core rate a product of these operand types needs: bf16
    when every operand is bf16, else TF32 (an f32-accurate product takes at
    least one TF32 pass)."""
    import torch

    return "bf16" if all(t == torch.bfloat16 for t in dtypes) else "tf32"


def bound_ms(shape, products, tensors):
    """The least time the card could take for a kernel's work: the larger of
    its (N x N x d) products over the tensor-core rate of their types and
    the bytes of its inputs and outputs, each moved once, over the memory
    rate. Returns (ms, "operations" or "bytes")."""
    B, h, N, d = shape
    ops_s = sum(2 * N * N * d * B * h / PEAK_FLOPS[kind] for kind in products)
    bytes_s = sum(t.numel() * t.element_size() for t in tensors) / PEAK_BYTES
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def library_fwd(q, k, v):
    """One PyTorch call that computes the forward kernel's function on
    (B, h, N, d) CUDA tensors with q pre-scaled -> (O, lse): efficient
    attention for f32 (v in q's type), flash attention for bf16; scale 1.
    A yardstick timed beside the kernel; the port never calls it."""
    import torch

    aten = torch.ops.aten
    if q.dtype == torch.float32:
        out = aten._scaled_dot_product_efficient_attention(q, k, v, None, True, scale=1.0)
    else:
        out = aten._scaled_dot_product_flash_attention(q, k, v, scale=1.0)
    return out[0], out[1][..., :q.shape[2]]


def library_bwd_fn(q, k, v, do):
    """The library's backward of the same attention (dq, dk and dv in one
    call: a yardstick for the dq and dkv kernels together), set up by one
    library forward; returns a function of no arguments that runs it."""
    import torch

    aten = torch.ops.aten
    if q.dtype == torch.float32:
        o, lse, seed, offset = aten._scaled_dot_product_efficient_attention(
            q, k, v, None, True, scale=1.0)
        return lambda: aten._scaled_dot_product_efficient_attention_backward(
            do, q, k, v, None, o, lse, seed, offset, 0.0, [True, True, True, False], False,
            scale=1.0)
    o, lse, cum_q, cum_k, max_q, max_k, rng, unused, _ = aten._scaled_dot_product_flash_attention(
        q, k, v, scale=1.0)
    return lambda: aten._scaled_dot_product_flash_attention_backward(
        do, q, k, v, o, lse, cum_q, cum_k, max_q, max_k, 0.0, False, rng, unused, scale=1.0)


def rand(shape, seed, dtype, scale=1.0):
    import numpy as np
    import torch

    a = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * scale
    return torch.from_numpy(a).cuda().to(dtype)


def check_kernel(fa):
    """Phase 3: kernel against plain version; returns {"max_abs_err": worst
    max|dO| at the production shape, "main" and "bf16": {"ms", "plain_ms",
    "library_ms", "bound_ms", "bound_by"}}."""
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
    out = {"max_abs_err": 0.0}
    for key, (qk_dt, v_dt) in (("bf16", (torch.bfloat16, torch.bfloat16)),
                               ("main", (torch.float32, torch.bfloat16))):
        q = rand(PROD_SHAPE, 1, torch.float32, d ** -0.5).to(qk_dt)
        k = rand(PROD_SHAPE, 2, torch.float32).to(qk_dt)
        v = rand(PROD_SHAPE, 3, torch.float32).to(v_dt)
        o, lse = fa.flash_fwd_cuda(q, k, v)
        o2, lse2 = fa.flash_fwd_cuda(q, k, v)
        torch.cuda.synchronize()
        tag = f"q/k {str(qk_dt)[6:]} v {str(v_dt)[6:]} {PROD_SHAPE}"
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            raise AssertionError(f"two forward launches differ ({tag})")
        o_ref, lse_ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), 1024, 1024)
        torch.cuda.synchronize()
        eo = (o.float() - o_ref).abs().max().item()
        el = (lse - lse_ref).abs().max().item()
        phase("kernel", f"{tag}: max|dO| {eo:.3g} (atol 2e-2) max|dlse| {el:.3g} (atol 1e-3); "
              "two launches bitwise equal")
        if not (eo <= 2e-2 and el <= 1e-3):
            raise AssertionError(f"kernel disagrees with plain version ({tag})")
        out["max_abs_err"] = max(out["max_abs_err"], eo)
        del o_ref, lse_ref, o2, lse2
        v_lib = v.to(qk_dt)  # the library takes one type; cast outside the timing
        o_lib, lse_lib = library_fwd(q, k, v_lib)
        phase("kernel", f"{tag}: library call vs kernel max|dO| "
              f"{(o_lib.float() - o.float()).abs().max().item():.3g} max|dlse| "
              f"{(lse_lib - lse).abs().max().item():.3g}")
        del o_lib, lse_lib
        means, runs = in_turns(plain=lambda: fa.flash_attention_plain(q, k, v, 1024, 1024),
                               kernel=lambda: fa.flash_fwd_cuda(q, k, v),
                               library=lambda: library_fwd(q, k, v_lib))
        bound, by = bound_ms(PROD_SHAPE, [product_kind(qk_dt, qk_dt), product_kind(v_dt, v_dt)],
                             [q, k, v, o, lse])
        phase("kernel", f"{tag}: {turns_line(means, runs)}; bound {bound:.3f} ms ({by}), "
              f"kernel at {bound / means['kernel']:.1%} of it")
        out[key] = {"ms": means["kernel"], "plain_ms": means["plain"],
                    "library_ms": means["library"], "bound_ms": bound, "bound_by": by}
    return out


# The dq kernel's instances at d = 192: (q/k type code, v type code, template types).
DQ_INSTANCES = {"main": (0, 1, "float, __nv_bfloat16"),
                "bf16": (1, 1, "__nv_bfloat16, __nv_bfloat16"),
                "f32": (0, 0, "float, float")}


def dq_build_report():
    """The dq kernel's CTA (from the library) and its registers and spills
    (from the build's `-Xptxas -v` log) for every instance at head dim 192;
    prints one line each and returns {"main" | "bf16" | "f32": {...}}."""
    import ctypes

    from vaevar_tpu_torch.ops import _build

    config = _build.load("flash_bwd").flash_bwd_dq_config
    config.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    config.restype = ctypes.c_int
    ptxas = _build.ptxas_report(_build.library_path("flash_bwd").with_suffix(".log").read_text())
    out = {}
    for key, (qk_type, v_type, types) in DQ_INSTANCES.items():
        cfg = (ctypes.c_int * 4)()
        if config(192, qk_type, v_type, cfg) != 0:
            raise AssertionError(f"flash_bwd_dq_config refused d = 192, types {types}")
        kern = f"flash_dq_kernel<{types}, 192>"
        if kern not in ptxas:
            raise AssertionError(f"{kern} is not in the ptxas log")
        regs, spill_st, spill_ld = ptxas[kern]
        out[key] = {"warps": cfg[0], "q_rows": cfg[1], "key_tile": cfg[2], "smem_bytes": cfg[3],
                    "registers": regs, "spill_stores": spill_st, "spill_loads": spill_ld}
        phase("bwd", f"{kern}: {cfg[0]} warps, {cfg[1]} q rows, {cfg[2]}-key tiles, "
              f"{cfg[3]} bytes of shared memory; {regs} registers, spill stores/loads "
              f"{spill_st}/{spill_ld} bytes (ptxas -v)")
    return out


def check_bwd(fa):
    """Phase 4: dq and dkv kernels against their plain versions; returns
    {kernel: {"max_abs_err": at the production shape, "main" and "bf16":
    {"ms", "plain_ms", "library_ms" (None: no one call computes one kernel's
    function), "bound_ms", "bound_by"}, and for dq "build" (dq_build_report)},
    "pair": {"main", "bf16": {"ms" of the whole backward, "library_ms" of the
    library's backward}}}."""
    import torch

    def grads_vs_plain(shape, qk_dt, v_dt, seed):
        d = shape[-1]
        q = rand(shape, seed, torch.float32, d ** -0.5).to(qk_dt)
        k = rand(shape, seed + 1, torch.float32).to(qk_dt)
        v = rand(shape, seed + 2, torch.float32).to(v_dt)
        do = rand(shape, seed + 3, torch.float32).to(qk_dt)
        o, lse = fa.flash_fwd_cuda(q, k, v)
        delta = (do.float() * o.float()).sum(-1)
        got = (fa.flash_dq_cuda(q, k, v, do, lse, delta),
               *fa.flash_dkv_cuda(q, k, v, do, lse, delta))
        again = (fa.flash_dq_cuda(q, k, v, do, lse, delta),
                 *fa.flash_dkv_cuda(q, k, v, do, lse, delta))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"two backward launches differ at {shape}")
        want = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(),
                                            lse, do.float())
        torch.cuda.synchronize()
        tag = f"q/k {str(qk_dt)[6:]} v {str(v_dt)[6:]} {shape}"
        errs = {}
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            err, scale = (a.float() - b).abs().max().item(), b.abs().max().item()
            tol = BWD_TOL[(str(qk_dt)[6:], str(a.dtype)[6:])] * scale
            phase("bwd", f"{tag}: {name} max|d| {err:.3g} <= {tol:.3g} "
                  f"(tol x max|ref| {scale:.3g})")
            if not err <= tol:
                raise AssertionError(f"{name} kernel disagrees with plain version ({tag})")
            errs[name] = err
        phase("bwd", f"{tag}: two launches bitwise equal")
        return (q, k, v, do, lse, delta), o, errs

    for i, shape in enumerate(SMALL_SHAPES):
        grads_vs_plain(shape, torch.float32, torch.float32, 20 + 10 * i)

    out = {"flash_dq": {"max_abs_err": 0.0, "build": dq_build_report()},
           "flash_dkv": {"max_abs_err": 0.0}, "pair": {}}
    for key, (qk_dt, v_dt) in (("bf16", (torch.bfloat16, torch.bfloat16)),
                               ("main", (torch.float32, torch.bfloat16))):
        args, o, errs = grads_vs_plain(PROD_SHAPE, qk_dt, v_dt, 5)
        q, k, v, do, lse, delta = args
        out["flash_dq"]["max_abs_err"] = max(out["flash_dq"]["max_abs_err"], errs["dq"])
        out["flash_dkv"]["max_abs_err"] = max(out["flash_dkv"]["max_abs_err"], errs["dk"],
                                              errs["dv"])
        tag = f"q/k {str(qk_dt)[6:]} v {str(v_dt)[6:]} {PROD_SHAPE}"
        kind = product_kind
        for name, kern_fn, plain_fn, products, outs in (
                ("flash_dq", fa.flash_dq_cuda, fa.flash_dq_plain,
                 [kind(qk_dt, qk_dt), kind(qk_dt, v_dt), kind(qk_dt, qk_dt)], [q]),
                ("flash_dkv", fa.flash_dkv_cuda, fa.flash_dkv_plain,
                 [kind(qk_dt, qk_dt), kind(v_dt, qk_dt), kind(qk_dt, qk_dt),
                  kind(qk_dt, qk_dt)], [k, v])):
            means, runs = in_turns(plain=lambda: plain_fn(*args), kernel=lambda: kern_fn(*args))
            bound, by = bound_ms(PROD_SHAPE, products, [*args, *outs])
            phase("bwd", f"{tag}: {name} {turns_line(means, runs)}; bound {bound:.3f} ms "
                  f"({by}), kernel at {bound / means['kernel']:.1%} of it")
            out[name][key] = {"ms": means["kernel"], "plain_ms": means["plain"],
                              "library_ms": None, "bound_ms": bound, "bound_by": by}
        v_lib = v.to(qk_dt)  # the library takes one type; cast outside the timing
        library = library_bwd_fn(q, k, v_lib, do)
        means, runs = in_turns(kernels=lambda: fa.flash_bwd_cuda(q, k, v, o, lse, do),
                               library=library)
        phase("bwd", f"{tag}: the whole backward (D, dq and dkv) against the library's "
              f"backward, a yardstick for the pair: {turns_line(means, runs)}")
        out["pair"][key] = {"ms": means["kernels"], "library_ms": means["library"]}
        del args, o, q, k, v, do, lse, delta, v_lib, library
    return out


def filled(build, seed):
    """build() without torch's default initialisation, then filled with
    JAX's --fast_init draw from `seed` (as run_da.build_model builds)."""
    from vaevar_tpu_torch.models.init import without_default_init
    from vaevar_tpu_torch.utils.fast_init import fast_init

    with without_default_init():
        model = build()
    return fast_init(model, seed=seed)


def micro_model(seed=3, **kw):
    """The micro rope LGUnet whose flash calls all have kernel head dims:
    full-grid LG stage (128 tokens, head dim 32) and unshifted 4x4 encoder
    and decoder windows (16 tokens, head dims 32 and 64)."""
    from vaevar_tpu_torch import config as cfgs
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.utils.fast_init import fast_init

    cfg = cfgs.micro_config(img_size=(32, 64), flash_min_seq=16, enc_dim=32,
                            embed_dim=64, lg_heads=(2,), **kw)
    return fast_init(LGUnet(cfg), seed=seed)


def check_model():
    """Phase 5: micro rope model with a flash stage, card against CPU: the
    forward, then one train step (f32, remat, Possloss)."""
    model_card_vs_cpu(micro_model, "model", "micro rope LGUnet")


def model_card_vs_cpu(build, name, what):
    """A micro model from `build(**kw)`, card against CPU in f32: the
    forward (atol 1e-4), then one Possloss train step with remat (loss atol
    1e-4, gradients 1e-3 x max|grad|); the step must launch dq and dkv."""
    import numpy as np
    import torch

    from vaevar_tpu_torch.train import forecast_trainer as ft

    model = build().eval()
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 69, 32, 64), dtype=np.float32))
    with torch.no_grad():
        y_cpu = model(x)
        y_gpu = model.cuda()(x.cuda()).cpu()
    err = (y_gpu - y_cpu).abs().max().item()
    phase(name, f"{what} card vs CPU: max|d| {err:.3g} (atol 1e-4), "
          f"finite {bool(torch.isfinite(y_gpu).all())}")
    if not (err <= 1e-4 and torch.isfinite(y_gpu).all()):
        raise AssertionError(f"{what} on the card disagrees with the CPU path")

    tar = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 69, 32, 64), dtype=np.float32))
    losses, grads = {}, {}
    for dev in ("cpu", "cuda"):
        model = build(remat=True).to(dev).train()
        init_fn, step = ft.make_forecast_train_step(model, "Possloss", lr=1e-4, total_steps=10,
                                                    out_shape=(138, 32, 64))
        trainable, opt_state = init_fn()
        mark = flash_launches()
        _, _, loss = step(trainable, opt_state, x.to(dev), [tar.to(dev)])
        launched = flash_launches(mark)[1:]
        losses[dev] = loss.item()
        grads[dev] = torch.cat([p.grad.flatten().cpu() for p in model.parameters()]
                               + [trainable[k].grad.flatten().cpu()
                                  for k in ("max_logvar", "min_logvar")])
    scale = grads["cpu"].abs().max().item()
    gerr = (grads["cuda"] - grads["cpu"]).abs().max().item()
    lerr = abs(losses["cuda"] - losses["cpu"])
    # f32 through ~40 layers in another summation order: the forward's 1e-4
    # and the gradients to 1e-3 of their largest entry
    phase(name, f"{what} train step card vs CPU: loss {losses['cuda']:.6g} vs "
          f"{losses['cpu']:.6g} (|d| {lerr:.3g}, atol 1e-4); gradients max|d| {gerr:.3g} "
          f"<= {1e-3 * scale:.3g} (1e-3 x max|grad|); dq/dkv launches {launched}")
    if not (lerr <= 1e-4 and gerr <= 1e-3 * scale and min(launched) > 0):
        raise AssertionError(f"the {what} train step on the card disagrees with the CPU path")


def micro_sd_model(seed=3, **kw):
    """`micro_model` with SD_attn's general path on: dilation (1, 1, 2) on
    the 4x4 encoder and decoder windows (total windows 4x8) and a (1, 4, 4)
    3-D window with rope3 in LG stage 1 (its shifted block masked); LG stage
    0 stays the full-grid flash stage (128 tokens, head dim 32)."""
    from vaevar_tpu_torch import config as cfgs
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.utils.fast_init import fast_init

    cfg = cfgs.micro_config(img_size=(32, 64), flash_min_seq=16, enc_dim=32, embed_dim=64,
                            lg_depths=(1, 2), lg_heads=(2, 2), lg_window_size=(1, 4, 4),
                            dilated_size=(1, 1, 2), **kw)
    return fast_init(LGUnet(cfg), seed=seed)


def zoo_cases(dim, heads, win, grid, dil, tokens, dtype=None):
    """(label, constructor, input shapes) for every module of models/zoo.py
    at one width: (1, *grid, dim) inputs, or (1, tokens, dim) for the ViT
    blocks (their context: tokens // 8)."""
    from vaevar_tpu_torch.models import zoo

    X = (1, *grid, dim)
    N = win[0] * win[1]
    shift = (win[0] // 2, win[1] // 2)
    s = min(128, dim)
    T, ctx = (1, tokens, dim), (1, tokens // 8, dim)
    kw = dict(dtype=dtype)
    return [
        ("ScaleOffset", lambda: zoo.ScaleOffset(dim), [X]),
        ("SEBlock", lambda: zoo.SEBlock(dim, **kw), [X]),
        ("RelativePositionalBias", lambda: zoo.RelativePositionalBias(win, heads),
         [(16, heads, N, N)]),
        ("CrossAttention", lambda: zoo.CrossAttention(dim, win, heads, **kw), [X, X]),
        ("ConvAttention", lambda: zoo.ConvAttention(dim, win, heads, **kw), [X]),
        ("DilatedAttention", lambda: zoo.DilatedAttention(dim, win, heads, dil, **kw), [X]),
        ("GAUAttention-lin", lambda: zoo.GAUAttention(dim, win, s=s, **kw), [X]),
        ("GAUAttention-quad", lambda: zoo.GAUAttention(dim, win, s=s, attn_type="quad", **kw),
         [X]),
        ("HydraAttention-local", lambda: zoo.HydraAttention(dim, win, heads, **kw), [X]),
        ("HydraAttention-global", lambda: zoo.HydraAttention(dim, win, heads, local=False, **kw),
         [X]),
        ("HydraAttention-hydra", lambda: zoo.HydraAttention(dim, win, heads, use_attn=False,
                                                            **kw), [X]),
        ("HiLoAttention", lambda: zoo.HiLoAttention(dim, heads, win, 0.5, **kw), [X]),
        ("MoEDense-cf0.5", lambda: zoo.MoEDense(dim, 4, dim, expert_capacity=0.5, **kw), [X]),
        ("MoEMlp", lambda: zoo.MoEMlp(dim, 4 * dim, 4, **kw), [X]),
        ("MoEWindowAttention", lambda: zoo.MoEWindowAttention(dim, win, heads, 4, shift, **kw),
         [X]),
        ("GluMlp", lambda: zoo.GluMlp(dim, 4 * dim, **kw), [X]),
        ("GatedMlp", lambda: zoo.GatedMlp(dim, grid, **kw), [X]),
        ("ConvMlp", lambda: zoo.ConvMlp(dim, 4 * dim, **kw), [X]),
        ("MAGMlp", lambda: zoo.MAGMlp(dim, win, **kw), [X]),
        ("RCAB", lambda: zoo.RCAB(dim, **kw), [X]),
        ("RDCAB", lambda: zoo.RDCAB(dim, **kw), [X]),
        ("DWMlp", lambda: zoo.DWMlp(dim, 4 * dim, **kw), [X]),
        ("ConvNeXtBlock", lambda: zoo.ConvNeXtBlock(dim, (4, 8), 12, 0.5, **kw), [X]),
        ("HiLoBlock", lambda: zoo.HiLoBlock(dim, win, heads, alpha=0.5, **kw), [X]),
        ("ConvFFNBlock", lambda: zoo.ConvFFNBlock(dim, **kw), [X]),
        ("MoEWindowBlock", lambda: zoo.MoEWindowBlock(dim, win, heads, 4, 4, shift, **kw), [X]),
        ("ViTAttention", lambda: zoo.ViTAttention(dim, heads, **kw), [T]),
        ("ViTCrossAttention", lambda: zoo.ViTCrossAttention(dim, heads, **kw), [T, ctx]),
        ("ViTBlock", lambda: zoo.ViTBlock(dim, heads, **kw), [T]),
        ("ViTDecoderBlock", lambda: zoo.ViTDecoderBlock(dim, heads, **kw), [T, ctx]),
    ]


ZOO_MICRO = dict(dim=48, heads=2, win=(2, 4), grid=(8, 16), dil=(2, 2), tokens=40)
# the backbone's LG-stage widths: FORECAST_025's encoder dim 192 and 6 heads,
# its 6x12 window, the 90x180 LG grid (16200 tokens)
ZOO_WIDE = dict(dim=192, heads=6, win=(6, 12), grid=(90, 180), dil=(1, 3), tokens=16200)


def _outputs(out):
    """A zoo module's output as (y, [scalar losses])."""
    if not isinstance(out, tuple):
        return out, []
    y, *rest = out
    return y, [t for r in rest for t in (r if isinstance(r, tuple) else (r,))]


def zoo_card_vs_cpu():
    """Every zoo module at micro size in f32, the same weights on the card
    and on the CPU: outputs within atol 1e-4, and every MoE router's expert
    indices equal except at a near-tie (the top two CPU probabilities within
    1e-5), which is counted. Returns (modules, largest |d|, routed tokens,
    near-tie flips)."""
    import copy

    import numpy as np
    import torch

    from vaevar_tpu_torch.ops import moe

    real_route = moe.top1_route
    worst, n_routed, flips = 0.0, 0, 0
    cases = zoo_cases(**ZOO_MICRO)
    try:
        for i, (label, build, shapes) in enumerate(cases):
            torch.manual_seed(i)
            m_cpu = build().eval()
            m_gpu = copy.deepcopy(m_cpu).cuda()
            xs = [torch.from_numpy(np.random.default_rng(i + j).standard_normal(sh, np.float32))
                  for j, sh in enumerate(shapes)]
            outs, routes = {}, {}
            for dev, m in (("cpu", m_cpu), ("cuda", m_gpu)):
                routes[dev] = []
                moe.top1_route = (lambda *a, _r=routes[dev], **k:
                                  _r.append(real_route(*a, **k)) or _r[-1])
                with torch.no_grad():
                    y, extra = _outputs(m(*(x.to(dev) for x in xs)))
                outs[dev] = [t.cpu() for t in (y, *extra)]
            errs = [(a - b).abs().max().item() for a, b in zip(outs["cuda"], outs["cpu"])]
            if not (max(errs) <= 1e-4 and all(torch.isfinite(t).all() for t in outs["cuda"])):
                raise AssertionError(f"zoo {label} on the card disagrees with the CPU: {errs}")
            worst = max(worst, *errs)
            for (ic, pc, _), (ig, _, _) in zip(routes["cpu"], routes["cuda"]):
                differ = ic.cpu() != ig.cpu()
                top2 = pc.cpu().topk(2, dim=-1).values
                near = (top2[..., 0] - top2[..., 1]) < 1e-5
                if bool((differ & ~near).any()):
                    raise AssertionError(f"zoo {label}: expert indices differ off a near-tie")
                n_routed += ic.numel()
                flips += int(differ.sum())
    finally:
        moe.top1_route = real_route
    return len(cases), worst, n_routed, flips


def zoo_at_width():
    """Forward and backward of every zoo module at the backbone's widths
    (ZOO_WIDE, b1, bf16 compute with f32 parameters) on the card, twice:
    the output and every parameter gradient finite; returns {label: (first,
    second) seconds of forward + backward} (host clock, synchronized; the
    first call of a shape pays the library's first-use set-up) and the peak
    memory."""
    import numpy as np
    import torch

    secs = {}
    torch.cuda.reset_peak_memory_stats()
    for i, (label, build, shapes) in enumerate(zoo_cases(**ZOO_WIDE, dtype=torch.bfloat16)):
        torch.manual_seed(i)
        with torch.device("cuda"):
            m = build().cuda().train()
        xs = [torch.from_numpy(np.random.default_rng(i + j).standard_normal(sh, np.float32))
              .cuda() for j, sh in enumerate(shapes)]
        secs[label] = []
        for _ in range(2):
            m.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, extra = _outputs(m(*xs))
            (y.float().square().mean() + sum(extra)).backward()
            torch.cuda.synchronize()
            secs[label].append(time.perf_counter() - t0)
        ok = bool(torch.isfinite(y).all()) and all(
            p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in m.parameters())
        if not ok:
            raise AssertionError(f"zoo {label} at backbone width: a non-finite output or "
                                 "gradient")
        del m, xs, y, extra
    return secs, torch.cuda.max_memory_allocated()


def check_sd_zoo():
    """Phase 15 (sd_zoo): SD_attn's general path and the layer zoo. (a)
    FORECAST_025-SD at 721x1440 (FORECAST_025 with lg_window_size (1, 6, 12)
    and dilated_size (1, 1, 3)), b1, bf16, remat, Possloss, random weights
    from the seed: one forward (4 flash forward launches: LG stage 0), then
    2 train steps (8, 4, 4 each) and an eval step (4) on one synthetic ERA5
    pair; finite losses, the eval loss below the first step's, and a finite
    nonzero gradient at LG stage 1's first qkv (the 3-D windowed stage).
    (b) the micro SD model card vs CPU (`model_card_vs_cpu`). (c) every zoo
    module card vs CPU at micro size, then forward and backward at the
    backbone's widths. Returns the launch counts of (a)."""
    from datetime import datetime, timedelta

    import numpy as np
    import torch

    from vaevar_tpu_torch import channels
    from vaevar_tpu_torch import config as cfgs
    from vaevar_tpu_torch.data.era5 import SyntheticEra5
    from vaevar_tpu_torch.models.lgunet import LGUnet, WindowAttention
    from vaevar_tpu_torch.train import forecast_trainer as ft

    t0 = time.perf_counter()
    cfg = cfgs.FORECAST_025.replace(lg_window_size=(1, 6, 12), dilated_size=(1, 1, 3),
                                    dtype=torch.bfloat16)
    model = filled(lambda: LGUnet(cfg), 0).cuda().train()
    n_model = sum(p.numel() for p in model.parameters())
    attns = [m for m in model.modules() if isinstance(m, WindowAttention)]
    n3d = sum(len(m.win) == 3 for m in attns)
    ndil = sum(m.dil == (1, 3) for m in attns)
    # LG stages 1-2 (4 + 4 blocks) and every encoder and decoder block (6
    # groups x 2 x (2 + 2 + 2)) take the general path
    if (n3d, ndil) != (8, 72) or not all(m.general for m in attns if len(m.win) == 3):
        raise AssertionError(f"FORECAST_025-SD built {n3d} 3-D and {ndil} dilated blocks")
    hw = cfg.img_size
    src = SyntheticEra5(hw=hw, seed=0)
    mean, std = channels.MEAN.reshape(-1, 1, 1), channels.STD.reshape(-1, 1, 1)
    t = datetime(2022, 1, 1)
    inp, tar = (torch.from_numpy(((src.get_state(ts) - mean) / std).astype(np.float32)[None])
                .cuda() for ts in (t, t + timedelta(hours=6)))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    counts = dict.fromkeys(("flash_fwd", "flash_dq", "flash_dkv"), 0)

    def launched():
        """The launches since the last call, added to the phase's counts."""
        nonlocal mark
        got, mark = flash_launches(mark), flash_launches()
        for name, n in zip(counts, got):
            counts[name] += n
        return got

    torch.cuda.reset_peak_memory_stats()
    mark = flash_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        y = model(inp)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    got = launched()
    if got != (4, 0, 0) or tuple(y.shape) != (1, 138, *hw) or not torch.isfinite(y).all():
        raise AssertionError(f"SD forward: launches {got}, shape {tuple(y.shape)}")
    del y

    init_fn, step = ft.make_forecast_train_step(model, "Possloss", lr=LR,
                                                total_steps=TOTAL_STEPS,
                                                out_shape=(2 * channels.N_CHANNELS, *hw))
    trainable, opt_state = init_fn()
    losses, secs = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        trainable, opt_state, loss = step(trainable, opt_state, inp, [tar])
        losses.append(loss.item())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        got = launched()
        if got != (8, 4, 4):
            raise AssertionError(f"SD train step launched (fwd, dq, dkv) {got}; want (8, 4, 4)")
    g = model.net.layers[1].blocks[0].attn.qkv.weight.grad
    qkv_ok = g is not None and bool(torch.isfinite(g).all()) and g.abs().max().item() > 0
    peak = torch.cuda.max_memory_allocated()
    after = ft.make_eval_step("Possloss")(trainable, inp, [tar])[0].item()
    got = launched()
    phase("sd_zoo", f"(a) FORECAST_025-SD {hw[0]}x{hw[1]} b1 bf16 remat (lg_window_size "
          f"(1, 6, 12), dilated_size (1, 1, 3)): {n_model / 1e6:.1f} M model parameters, "
          f"{n3d} 3-D window blocks, {ndil} dilated blocks; set-up "
          f"{setup_s:.2f} s; forward {fwd_s:.3f} s; 2 steps: losses "
          + ", ".join(f"{v:.6g}" for v in losses) + f"; seconds {secs[0]:.3f} (first), "
          f"{secs[1]:.3f}; eval loss after {after:.6g}; peak memory {peak / 2**30:.2f} GiB; "
          f"LG stage-1 (3-D window) qkv gradient finite and nonzero: {qkv_ok}; launches "
          f"(fwd, dq, dkv) forward (4, 0, 0), per step (8, 4, 4), eval {got}; phase total "
          f"{counts}")
    if got != (4, 0, 0) or not (all(np.isfinite(losses)) and after < losses[0] and qkv_ok):
        raise AssertionError(f"SD training went wrong: losses {losses}, after {after}, "
                             f"qkv gradient ok {qkv_ok}, eval launches {got}")
    del model, trainable, opt_state, inp, tar
    gc.collect()
    torch.cuda.empty_cache()

    model_card_vs_cpu(micro_sd_model, "sd_zoo", "(b) micro SD LGUnet")

    t0 = time.perf_counter()
    n, worst, routed, flips = zoo_card_vs_cpu()
    phase("sd_zoo", f"(c) {n} zoo modules at micro size (dim 48, 2 heads, window 2x4, grid "
          f"8x16), f32, card vs CPU: max|d| {worst:.3g} (atol 1e-4); MoE routes equal on "
          f"{routed - flips} of {routed} tokens, {flips} flips at near-ties (top-2 gap < 1e-5); "
          f"{time.perf_counter() - t0:.2f} s")
    secs, peak = zoo_at_width()
    phase("sd_zoo", "(c) forward + backward at backbone widths (dim 192, 6 heads, window "
          "6x12, grid 90x180, b1, bf16), seconds of the first and second call: "
          + ", ".join(f"{k} {a:.3f} {b:.3f}" for k, (a, b) in secs.items())
          + f"; peak memory {peak / 2**30:.2f} GiB; all finite")
    return counts


def check_window(extra=()):
    """Phase 6b: the 4D-Var window cycle at full width (WINDOW_ARGS and
    `extra` flags of run_da); returns its forward launches and the
    run's CycledDA."""
    import torch

    from vaevar_tpu_torch import run_da

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as work:
        mark = flash_launches()
        t0 = time.perf_counter()
        da = run_da.main(WINDOW_ARGS + list(extra) + ["--work_dir", work])
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = flash_launches(mark)
        files = sorted(os.listdir(da.work_dir))
    peak = torch.cuda.max_memory_allocated()
    if len(da.cycle_log) != 1:
        raise AssertionError(f"{len(da.cycle_log)} window cycles; want 1")
    c = da.cycle_log[0]
    j = [b + o for b, o in zip(c["jb"], c["jo"])]
    phase("window", f"{' '.join(extra) or 'defaults'}: da_win 6 cycle in "
          f"{c['seconds']:.2f} s ({total:.2f} s with the model set-up): obs preparation "
          f"{c['obs_s']:.2f} s, reduction {c['reduce_s']:.3f} s, solve {c['solve_s']:.2f} s; "
          f"linesearch {c['linesearch']}; iterations {c['n_iters']}, charged evals "
          f"{c['n_evals']}, jvp probes {c['n_jvp']}, gradient restores {c['n_restore']}; "
          f"J {j[0]:.6g} -> {j[-1]:.6g} ({', '.join(f'{v:.6g}' for v in j)}); "
          f"peak memory {peak / 2**30:.2f} GiB; flash launches (fwd, dq, dkv) {counts}")
    if counts != (4, 0, 0):
        raise AssertionError(f"window cycle launched (fwd, dq, dkv) {counts}; want (4, 0, 0)")
    if c["linesearch"] != "jvp-zoom":
        raise AssertionError(f"auto resolved to {c['linesearch']}; want jvp-zoom")
    # the approximate-decrease test lets a step raise J by up to 1e-6 |J|
    slack = 1e-6 * abs(j[0]) * sum(c["n_iters"])
    if not (max(j) <= j[0] + slack and j[-1] < j[0]):
        raise AssertionError(f"the window solve did not lower J: {j}")
    if not (c["xa_finite"] and c["xb_next_finite"]):
        raise AssertionError("non-finite analysis or background in the window cycle")
    need = {"xb.npy", "current_time.txt", "bg_wrmse.npy", "ana_wrmse.npy"}
    if not need <= set(files):
        raise AssertionError(f"missing from the window work dir: {sorted(need - set(files))}")
    return counts[0], da


def micro_window_problem(device, da_win=3, low=(32, 64), full=(47, 93)):
    """(cost, to_state, z0, bundle) of a micro f32 window cost with block and
    step remat: relbias decoder and flow model, a 47x93 analysis grid over a
    32x64 solver grid (a non-integer ratio, so the gather S is a real one)."""
    import numpy as np
    import torch

    from vaevar_tpu_torch import channels
    from vaevar_tpu_torch import config as cfgs
    from vaevar_tpu_torch.da import cost as cost_mod
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.utils.fast_init import fast_init

    dec = fast_init(LGUnet(cfgs.micro_vae_configs(img_size=low)[1].replace(remat=True)), seed=1)
    flow = fast_init(LGUnet(cfgs.micro_config(img_size=low, attn_type="relbias", remat=True)),
                     seed=2)
    dec, flow = (m.to(device).eval().requires_grad_(False) for m in (dec, flow))
    rr = np.random.default_rng(0)
    m, s = channels.MEAN.reshape(-1, 1, 1), channels.STD.reshape(-1, 1, 1)
    arrs = (m + s * rr.normal(size=(69, *full)),
            m[None] + s[None] * rr.normal(size=(da_win, 69, *full)),
            rr.random((da_win, 69, *full)) < 0.3,
            s[None] ** 2 * (0.5 + rr.random((da_win, 69, *full))))
    bundle = cost_mod.reduce_obs_window(cost_mod.ObsBundle(*(
        torch.as_tensor(np.asarray(a, np.float32), device=device) for a in arrs)), low)
    cost, to_state, parts = cost_mod.make_vae4dvar_cost_window_reduced(dec, flow, da_win=da_win)
    z0 = torch.as_tensor(0.1 * rr.standard_normal((1, 8, *low)), dtype=torch.float32,
                         device=device)
    return cost, to_state, parts, z0, bundle


def check_micro_window():
    """Phase 6b, second part: forward-mode AD on the card. The jvp slope of
    the micro window cost against grad . u, then one solve with zoom and one
    with jvp-zoom: equal counts, analyses within norm-relative 1e-5."""
    import torch

    from vaevar_tpu_torch.da import lbfgs
    from vaevar_tpu_torch.da.solver import VariationalSolver

    cost, to_state, parts, z0, bundle = micro_window_problem("cuda")
    u = torch.randn(z0.shape, generator=torch.Generator().manual_seed(5)).cuda()
    v, g = lbfgs.value_and_grad(lambda q: cost(q, bundle), z0)
    vj, slope = lbfgs.value_and_slope(lambda q: cost(q, bundle), z0, u)
    want = float((g * u).sum())
    rel = abs(float(slope) - want) / abs(want)
    phase("window", f"micro f32 window cost on the card: jvp slope {float(slope):.7g} against "
          f"grad . u {want:.7g} (rel {rel:.2g}, tol 1e-5); values {float(vj):.7g}, {float(v):.7g}")
    if not rel <= 1e-5:
        raise AssertionError("the jvp slope disagrees with the gradient on the card")
    out = {}
    for ls in ("zoom", "jvp-zoom"):
        solver = VariationalSolver(cost, to_state, parts, lbfgs_iters=4, history=4,
                                   linesearch=ls)
        _, xa, diag = solver.solve(z0, bundle, nit=2, verbose=False)
        out[ls] = (xa, diag)
    (xz, dz), (xj, dj) = out["zoom"], out["jvp-zoom"]
    nrel = float((xj - xz).norm() / xz.norm())
    phase("window", f"micro solve, zoom: iterations {dz.n_iters}, evals {dz.n_evals}; jvp-zoom: "
          f"iterations {dj.n_iters}, evals {dj.n_evals}, jvp probes {dj.n_jvp}, restores "
          f"{dj.n_restore}; analyses norm-rel {nrel:.2g} (tol 1e-5)")
    if (dz.n_iters, dz.n_evals) != (dj.n_iters, dj.n_evals) or not nrel <= 1e-5:
        raise AssertionError("jvp-zoom and zoom took different steps on the card")
    if sum(dj.n_jvp) == 0:
        raise AssertionError("the micro solve ran no jvp probe")


def check_forecast_training():
    """Phase 7: FORECAST_025 train steps at full width; returns the launch
    counts of the phase, the last step's seconds and what the
    spatial_forecast phase holds its ranks to: the first 2 steps' losses,
    the step-1 gradient norm of each tensor of the trainable and the file of
    its parameters after step 2 (both taken off the steps' clock), the inputs'
    file and the peak memory."""
    from datetime import datetime, timedelta

    import numpy as np
    import torch

    from vaevar_tpu_torch import channels
    from vaevar_tpu_torch import config as cfgs
    from vaevar_tpu_torch.data.era5 import SyntheticEra5
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.train import forecast_trainer as ft

    t0 = time.perf_counter()
    cfg = cfgs.FORECAST_025.replace(dtype=torch.bfloat16)  # remat on
    model = filled(lambda: LGUnet(cfg), 0).cuda().train()
    hw = cfg.img_size
    src = SyntheticEra5(hw=hw, seed=0)
    mean, std = channels.MEAN.reshape(-1, 1, 1), channels.STD.reshape(-1, 1, 1)
    t = datetime(2022, 1, 1)
    inp, tar = (torch.from_numpy(((src.get_state(ts) - mean) / std).astype(np.float32)[None])
                .cuda() for ts in (t, t + timedelta(hours=6)))
    init_fn, step = ft.make_forecast_train_step(model, "Possloss", lr=LR,
                                                total_steps=TOTAL_STEPS,
                                                out_shape=(2 * channels.N_CHANNELS, *hw))
    trainable, opt_state = init_fn()
    n_model = sum(p.numel() for p in model.parameters())
    n_bounds = trainable["max_logvar"].numel()
    torch.cuda.synchronize()
    phase("train", f"FORECAST_025 {hw[0]}x{hw[1]} b1 bf16 remat: {n_model / 1e6:.1f} M model "
          f"parameters + 2 x {n_bounds / 1e6:.1f} M logvar bounds; set-up "
          f"{time.perf_counter() - t0:.2f} s")

    ref_dir = tempfile.mkdtemp(prefix="train_ref")
    atexit.register(shutil.rmtree, ref_dir, True)
    ref = {"inputs": os.path.join(ref_dir, "inputs.pt"),
           "params": os.path.join(ref_dir, "params.pt")}
    torch.save({"inp": inp.cpu(), "tar": tar.cpu()}, ref["inputs"])
    torch.cuda.reset_peak_memory_stats()
    counts = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
    losses, secs = [], []
    for k in range(3):
        mark = flash_launches()
        t0 = time.perf_counter()
        trainable, opt_state, loss = step(trainable, opt_state, inp, [tar])
        losses.append(loss.item())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        got = flash_launches(mark)
        if got != (8, 4, 4):
            raise AssertionError(f"train step launched (fwd, dq, dkv) {got}; want (8, 4, 4)")
        for name, n in zip(counts, got):
            counts[name] += n
        if k == 0:  # off the steps' clock: the spatial_forecast phase's references
            ref["norms"] = [float(p.grad.float().norm()) for p in ft.trainable_parameters(trainable)]
        if k == 1:
            torch.save({k: v.detach().cpu() for k, v in named_trainable(trainable)},
                       ref["params"])
    qkv = [blk.attn.qkv.weight.grad for blk in model.net.layers[0].blocks]
    qkv_ok = all(g is not None and bool(torch.isfinite(g).all()) and g.abs().max().item() > 0
                 for g in qkv)
    peak = torch.cuda.max_memory_allocated()
    ref.update(losses=losses[:2], peak_gib=peak / 2 ** 30)
    phase("train", f"3 steps: losses " + ", ".join(f"{v:.6g}" for v in losses)
          + f"; seconds {secs[0]:.3f} (first), " + ", ".join(f"{v:.3f}" for v in secs[1:])
          + f"; peak memory {peak / 2**30:.2f} GiB; LG stage-0 qkv gradients finite and "
          f"nonzero: {qkv_ok}; launches per step (fwd, dq, dkv) (8, 4, 4)")
    if not (all(np.isfinite(losses)) and losses[2] < losses[0] and qkv_ok):
        raise AssertionError(f"training went wrong: losses {losses}, qkv gradients ok {qkv_ok}")

    mark = flash_launches()
    t0 = time.perf_counter()
    loss, pred = ft.make_eval_step("Possloss")(trainable, inp, [tar])
    loss = loss.item()
    torch.cuda.synchronize()
    got = flash_launches(mark)
    phase("train", f"eval step: loss {loss:.6g} in {time.perf_counter() - t0:.3f} s; "
          f"prediction {tuple(pred.shape)} finite {bool(torch.isfinite(pred).all())}; "
          f"launches (fwd, dq, dkv) {got}")
    if got != (4, 0, 0) or not (np.isfinite(loss) and torch.isfinite(pred).all()):
        raise AssertionError(f"eval step: launches {got}, loss {loss}")
    counts["flash_fwd"] += got[0]
    return counts, secs[-1], ref


def named_trainable(trainable):
    """(name, tensor) of a forecast trainable: the model's state_dict under
    model.<key>, then the logvar bounds."""
    for k, v in trainable["model"].state_dict().items():
        yield f"model.{k}", v
    for k in ("max_logvar", "min_logvar"):
        yield k, trainable[k]


def check_cli():
    """Phase 8: the trainer CLI at micro size on the card, then its resume."""
    from vaevar_tpu_torch import run_train_forecast

    with tempfile.TemporaryDirectory() as out:
        argv = ["--micro", "--grid", "32x64", "--batch_size", "2", "--steps", "2",
                "--end_time", "2022-01-04 00:00:00", "--out_dir", out, "--log_every", "1"]
        _, first = run_train_forecast.main(argv)
        _, second = run_train_forecast.main(argv + ["--epochs", "2"])
        with open(os.path.join(out, "checkpoint_latest.meta.json")) as f:
            meta = json.load(f)
        with open(os.path.join(out, "run.log")) as f:
            resumed = "resumed at epoch 1 step 2" in f.read()
        files = set(os.listdir(out))
    phase("cli", f"run 1 losses {first}; run 2 losses {second}; meta {meta}; "
          f"resumed at epoch 1 step 2: {resumed}")
    need = {"checkpoint_latest", "checkpoint_best", "params_latest", "scalars.jsonl"}
    if not (len(first) == len(second) == 2 and resumed and meta["step"] == 4
            and need <= files and all(map(math.isfinite, first + second))):
        raise AssertionError("the trainer CLI did not train, validate, save and resume")


def vae_step_on(dev, frames, eps, mesh=None, **overrides):
    """One micro f32 VAE train step (run_train_vae --micro's configs at
    32x64 with `overrides`, nmc_steps 2) on `dev` with the given noise, or
    with a TrainMesh on this rank's tile of frames and noise (the models
    partitioned, the gradients summed over the ranks); returns (loss, the
    VAE's gradients as one CPU vector)."""
    import torch

    from vaevar_tpu_torch import config as cfgs
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.models.vae import VAE
    from vaevar_tpu_torch.train import vae_trainer as vt
    from vaevar_tpu_torch.utils.fast_init import fast_init

    flow_cfg, enc_cfg, dec_cfg = cfgs.micro_vae_train_configs(img_size=(32, 64), **overrides)
    flow = fast_init(LGUnet(flow_cfg), seed=1).to(dev).eval().requires_grad_(False)
    vae = fast_init(VAE(enc_cfg, dec_cfg), seed=2).to(dev)
    if mesh is not None:
        rows, cols = mesh.tiling.tile((32, 64))
        frames, eps = frames[..., rows, cols], eps[..., rows, cols]
    init_fn, step = vt.make_vae_train_step(vae, flow, latent_hw=(32, 64), nmc_steps=2, mesh=mesh)
    m = step(init_fn(), frames.to(dev), eps=eps.to(dev))
    grads = torch.cat([p.grad.flatten().cpu() for p in vae.parameters()])
    return m["loss"].item(), grads


def check_vae_train():
    """Phase 10: the NMC VAE trainer. A micro step card vs CPU with a fixed
    noise; 3 steps of train_vae at run_train_vae's defaults (b8, 128x256,
    bf16, remat, nmc_steps 4) on one batch, with the loss finite, lower at
    a fixed noise draw after the steps than before, the parameters moved by
    about lr and no flash launch, seconds per step (the first apart) from
    the step logs, then one more step split into its NMC sample, forward +
    backward and Adam; the CLI at micro size, trained, resumed and its
    vae_latest read by run_da. Returns the flash launches of the 3 steps,
    and what the spatial_train phase holds its ranks to: the micro step's
    frames and noise, the 3 steps' metrics, the step-1 gradient norms per parameter and the parameters
    after step 2 (both taken off the steps' clock), and the peak memory."""
    import numpy as np
    import torch

    from vaevar_tpu_torch import config as cfgs
    from vaevar_tpu_torch import run_da, run_train_vae
    from vaevar_tpu_torch.data.era5 import SyntheticEra5
    from vaevar_tpu_torch.data.nmc import NMCSequenceDataset, batched_loader
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.models.vae import VAE
    from vaevar_tpu_torch.train import checkpoint as ckpt
    from vaevar_tpu_torch.train import vae_trainer as vt
    from vaevar_tpu_torch.utils import jax_random

    rng = np.random.default_rng(6)
    frames = torch.from_numpy(rng.standard_normal((2, 3, 69, 32, 64), dtype=np.float32))
    eps = torch.from_numpy(rng.standard_normal((2, 32, 32, 64), dtype=np.float32))
    (l_cpu, g_cpu), (l_gpu, g_gpu) = (vae_step_on(d, frames, eps) for d in ("cpu", "cuda"))
    ref = {"micro": {"frames": frames, "eps": eps}}
    scale = g_cpu.abs().max().item()
    gerr = (g_gpu - g_cpu).abs().max().item()
    # f32 through the flow rollout and ~30 VAE layers in another summation
    # order: the loss to 1e-5 of itself, the gradients to 1e-3 of the largest
    phase("vae_train", f"micro f32 step card vs CPU, fixed noise: loss {l_gpu:.7g} vs "
          f"{l_cpu:.7g} (rel {abs(l_gpu - l_cpu) / abs(l_cpu):.2g}, tol 1e-5); gradients "
          f"max|d| {gerr:.3g} <= {1e-3 * scale:.3g} (1e-3 x max|grad|)")
    if not (abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu) and gerr <= 1e-3 * scale):
        raise AssertionError("the micro VAE step on the card disagrees with the CPU path")

    t0 = time.perf_counter()
    hw, dt = (128, 256), torch.bfloat16
    flow, enc_cfg, dec_cfg = (c.replace(img_size=hw, dtype=dt, remat=True)
                              for c in (cfgs.FLOW_140, cfgs.VAE_ENCODER, cfgs.VAE_DECODER))
    flow = filled(lambda: LGUnet(flow), 0).cuda().eval().requires_grad_(False)
    vae = filled(lambda: VAE(enc_cfg, dec_cfg), 1).cuda()
    ds = NMCSequenceDataset(SyntheticEra5(hw=hw, seed=0), START, "2022-02-01 00:00:00")
    batch = next(batched_loader(ds, 8, seed=0))
    n_vae = sum(p.numel() for p in vae.parameters())
    torch.cuda.synchronize()
    phase("vae_train", f"VAE_ENCODER + VAE_DECODER {n_vae / 1e6:.1f} M parameters, FLOW_140 "
          f"{sum(p.numel() for p in flow.parameters()) / 1e6:.1f} M, batch {batch.shape} from "
          f"{len(ds)} NMC sequences; set-up {time.perf_counter() - t0:.2f} s")
    marks, pauses = [], []

    def log(msg):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), msg))
        if " iter 0 " in msg:  # step 1's gradients, per parameter
            ref["grad_norms"] = torch.stack([p.grad.float().norm() for p in vae.parameters()]).cpu()
        if " iter 1 " in msg:  # the parameters after step 2
            ref["params"] = {k: v.detach().to("cpu", copy=True) for k, v in vae.state_dict().items()}
        pauses.append(time.perf_counter() - marks[-1][0])  # off the steps' clock

    def latent_noise(seed, err):
        """A noise draw of the latent's shape for the batch of `err`."""
        return jax_random.normal(jax_random.prng_key(seed), (
            err.shape[0], sum(vae.dec.cfg.inchans_list), *err.shape[-2:]), "cuda")

    def fixed_noise_loss():
        """The loss on the batch at one fixed noise draw: the 3 steps each
        draw their own, so only this shows that the steps lowered it."""
        vae.eval()
        with torch.no_grad():
            err = vt.nmc_error_sample(torch.as_tensor(batch).cuda(), flow, hw)
            return vt.vae_loss(vae, err, 2.0, eps=latent_noise(99, err))[0].item()

    loss_before = fixed_noise_loss()
    params_before = [p.detach().cpu() for p in vae.parameters()]  # off the card's peak
    torch.cuda.reset_peak_memory_stats()
    mark = flash_launches()
    t0 = time.perf_counter()
    _, hist = vt.train_vae(vae, flow, [batch] * 3, epochs=1, logger=log, log_every=1,
                           latent_hw=hw)
    torch.cuda.synchronize()
    counts = flash_launches(mark)
    peak = torch.cuda.max_memory_allocated()
    loss_after = fixed_noise_loss()
    lr = 1e-4
    moves = [(p.detach().cpu() - q).abs() for p, q in zip(vae.parameters(), params_before)]
    moved = sum(int((d >= 0.5 * lr).sum()) for d in moves)
    max_move = max(float(d.max()) for d in moves)
    del moves
    del params_before
    ends = [(t, p) for (t, msg), p in zip(marks, pauses) if " iter " in msg]
    secs = [b - a for a, (b, _) in zip([t0] + [t + p for t, p in ends[:-1]], ends)]
    losses = [h["loss"] for h in hist]
    ref.update(hist=hist, peak_gib=peak / 2 ** 30)
    prior = [msg for _, msg in marks if "prior-sample" in msg]
    phase("vae_train", "3 train_vae steps at b8 128x256 bf16 remat nmc_steps 4: losses "
          + ", ".join(f"{v:.7g}" for v in losses) + f"; seconds {secs[0]:.3f} (first, with "
          f"the probe), " + ", ".join(f"{v:.3f}" for v in secs[1:]) + f"; peak memory "
          f"{peak / 2**30:.2f} GiB; {prior[0] if prior else 'no prior sample'}; flash "
          f"launches (fwd, dq, dkv) {counts}")
    # 3 Adam steps move each parameter by up to about 3 lr, and by at least
    # lr / 2 wherever the gradient keeps its sign
    phase("vae_train", f"loss at a fixed noise draw {loss_before:.7g} -> {loss_after:.7g}; "
          f"parameters moved >= lr/2: {moved / n_vae:.4f} of {n_vae} (want > 0.5), max |dp| "
          f"{max_move:.3g} (want <= 4 lr = {4 * lr:.3g})")
    if counts != (0, 0, 0):
        raise AssertionError(f"the VAE train step launched flash kernels {counts}; want none")
    if not (len(losses) == 3 and all(np.isfinite(losses)) and loss_after < loss_before):
        raise AssertionError(f"VAE training went wrong: losses {losses}, at a fixed noise draw "
                             f"{loss_before} -> {loss_after}")
    if not (moved > 0.5 * n_vae and max_move <= 4 * lr):
        raise AssertionError("the 3 Adam steps did not move the VAE's parameters by about lr")

    init_fn, _ = vt.make_vae_train_step(vae, flow, latent_hw=hw)
    opt = init_fn()
    frames = torch.as_tensor(batch).cuda()
    for k in range(2):  # the second step's split (the first allocates Adam's state)
        t = [time.perf_counter()]
        err = vt.nmc_error_sample(frames, flow, hw)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        opt.zero_grad(set_to_none=True)
        vt.vae_loss(vae, err, 2.0, eps=latent_noise(k, err))[0].backward()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        opt.step()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
    split = [b - a for a, b in zip(t, t[1:])]
    phase("vae_train", f"one step split (host clock, synchronized): NMC sample {split[0]:.3f} s, "
          f"forward + backward {split[1]:.3f} s, Adam {split[2]:.3f} s; total {sum(split):.3f} s")
    del vae, flow, opt, err, frames
    gc.collect()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as out:
        argv = ["--micro", "--fast_init", "--grid", "32x64", "--batch_size", "2",
                "--end_time", "2022-01-03 00:00:00", "--out_dir", out]
        _, first = run_train_vae.main(argv + ["--epochs", "1"])
        _, second = run_train_vae.main(argv + ["--epochs", "2"])
        with open(os.path.join(out, "run.log")) as f:
            resumed = "resumed from" in f.read()
        da = run_da.main(["--micro", "--fast_init", "--grid", "32x64", "--solver_grid", "32x64",
                          "--init_lag", "1", "--Nit", "1", "--end_time", "2022-01-01 06:00:00",
                          "--vae_ckpt", os.path.join(out, "vae_latest"),
                          "--work_dir", os.path.join(out, "da")])
        saved = ckpt.restore(os.path.join(out, "vae_latest"))
    loaded = all(torch.equal(v.cpu(), saved["dec." + k]) for k, v in da.decoder.state_dict().items())
    phase("vae_train", f"CLI micro: run 1 losses {[round(h['loss'], 3) for h in first]}, run 2 "
          f"{[round(h['loss'], 3) for h in second]}, resumed {resumed}; run_da read vae_latest: "
          f"decoder equal {loaded}, latent {da.cfg.latent_shape}, cycle xa finite "
          f"{da.cycle_log[0]['xa_finite']}")
    if not (len(first) == len(second) == 2 and resumed and loaded and da.cycle_log[0]["xa_finite"]):
        raise AssertionError("the VAE trainer CLI did not train, resume and hand run_da its VAE")
    return counts[0], ref


def check_sc4dvar():
    """Phase 11: sc4dvar. The CVT increment card vs CPU in f32, then the
    README's cycle as sc4dvar at full width for 2 cycles; returns its
    forward launches."""
    import contextlib
    import io

    import numpy as np
    import torch

    from vaevar_tpu_torch import config as cfgs
    from vaevar_tpu_torch import run_da
    from vaevar_tpu_torch.da.cvt import BMatrixAssets, CVTransform

    t0 = time.perf_counter()
    b = BMatrixAssets.synthetic(2.0, device="cuda")  # cached: run_da below takes these
    cal_s = time.perf_counter() - t0
    u = torch.from_numpy(np.random.default_rng(7).standard_normal((69, 128, 256),
                                                                  dtype=np.float32))
    want = CVTransform(b, device="cpu").increment(u)
    got = CVTransform(b, device="cuda").increment(u.cuda()).cpu()
    nrel = float((got - want).norm() / want.norm())
    phase("sc4dvar", f"CVT increment at 128x256 card vs CPU, f32: norm-rel {nrel:.3g} (tol 1e-5); "
          f"synthetic B calibration {cal_s:.2f} s (card)")
    if not nrel < 1e-5:
        raise AssertionError("the CVT increment on the card disagrees with the CPU")

    argv = ["--da_mode", "sc4dvar"] + MAIN_ARGS[2:]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    err = io.StringIO()
    with tempfile.TemporaryDirectory() as work:
        mark = flash_launches()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stderr(err):
                da = run_da.main(argv + ["--work_dir", work])
        finally:
            sys.stderr.write(err.getvalue())
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = flash_launches(mark)
        files = sorted(os.listdir(da.work_dir))
    peak = torch.cuda.max_memory_allocated()
    warned = "WARNING: B-matrix coefficient dir" in err.getvalue()
    want = (da.cfg.init_lag + len(da.cycle_log)) * cfgs.FORECAST_025.lg_depths[0]
    phase("sc4dvar", f"{len(da.cycle_log)} cycles in {total:.2f} s; spin-up "
          f"{da.timings['spin_up_s']:.2f} s; cycles "
          + ", ".join(f"{s:.2f}" for s in da.timings["cycle_s"]) + f" s; peak memory "
          f"{peak / 2**30:.2f} GiB; decoder built {da.decoder is not None}; synthetic-B "
          f"WARNING on stderr {warned}; flash launches (fwd, dq, dkv) {counts}")
    if len(da.cycle_log) != 2 or counts != (want, 0, 0) or not warned or da.decoder is not None:
        raise AssertionError(f"sc4dvar: {len(da.cycle_log)} cycles, launches {counts} "
                             f"(want 2, ({want}, 0, 0)), warned {warned}")
    for c in da.cycle_log:
        j = [jb + jo for jb, jo in zip(c["jb"], c["jo"])]
        per_segment = np.diff([0] + c["n_iters"])  # the counts are cumulative
        phase("sc4dvar", f"cycle {c['time']}: {c['seconds']:.2f} s (obs {c['obs_s']:.2f} s, "
              f"solve {c['solve_s']:.2f} s); linesearch {c['linesearch']}; iterations per "
              f"segment {per_segment.tolist()}, charged evals {c['n_evals']}, jvp probes "
              f"{c['n_jvp']}; J {j[0]:.6g} -> {j[-1]:.6g}")
        if not (c["xa_finite"] and c["xb_next_finite"] and per_segment.max() <= 5):
            raise AssertionError(f"sc4dvar cycle {c['time']}: non-finite fields or more than "
                                 "5 iterations in a segment")
        if not (j[-1] < j[0] and max(j) <= j[0] + 1e-6 * abs(j[0]) * c["n_iters"][-1]):
            raise AssertionError(f"the sc4dvar solve did not lower J at {c['time']}: {j}")
    need = {"xb.npy", "current_time.txt", "bg_wrmse.npy", "ana_wrmse.npy"}
    if not need <= set(files):
        raise AssertionError(f"missing from the sc4dvar work dir: {sorted(need - set(files))}")
    return counts[0]


def write_record_inputs(root):
    """Phase 9's inputs under `root`: the reference-layout store (and one
    state-layout frame for the read timings), the three checkpoints.
    Returns (paths, seconds of the conversions)."""
    from datetime import datetime, timedelta

    import numpy as np
    import torch

    from vaevar_tpu_torch import config as cfgs
    from vaevar_tpu_torch import convert_ckpt
    from vaevar_tpu_torch.data.era5 import LocalNpyStore, ReferenceLayoutStore, SyntheticEra5
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.models.vae import VAE
    from vaevar_tpu_torch.train import checkpoint as ckpt

    t0 = time.perf_counter()
    hw = cfgs.FORECAST_025.img_size
    start = datetime(2022, 1, 1)
    src = SyntheticEra5(hw=hw, seed=0)
    paths = {"era5": os.path.join(root, "era5"), "era5_state": os.path.join(root, "era5_state")}
    store = ReferenceLayoutStore(paths["era5"], hw)
    for ts in (start - timedelta(hours=48), start):
        store.save_state(ts, src.get_state(ts))
        if not np.array_equal(store.get_state(ts), src.get_state(ts)):
            raise AssertionError(f"the reference-layout store does not read back {ts}")
    LocalNpyStore(paths["era5_state"], hw).save_state(start, src.get_state(start))
    phase("record", f"store: 2 frames of 69 x {hw[0]}x{hw[1]} f32 in the reference layout "
          f"({2 * 69} files), read back bit for bit through the {store.reader} reader; "
          f"{time.perf_counter() - t0:.2f} s with the synthetic source")

    bounds = {"max_logvar": torch.ones(1, 69), "min_logvar": -torch.ones(1, 69)}
    sources = {
        "forecast": lambda: {"model": {"lgunet_all": {
            "module." + k: v for k, v in {**filled(lambda: LGUnet(cfgs.FORECAST_025), 11)
                                          .state_dict(), **bounds}.items()}}},
        "vae": lambda: filled(lambda: VAE(cfgs.VAE_ENCODER, cfgs.VAE_DECODER), 12).state_dict()}
    convert_s = {}
    for kind, make in sources.items():
        pth, paths[kind] = os.path.join(root, f"{kind}.pth"), os.path.join(root, f"{kind}.pt")
        obj = make()
        torch.save(obj, pth)
        t0 = time.perf_counter()
        convert_ckpt.main([kind, pth, paths[kind]])
        convert_s[kind] = time.perf_counter() - t0
        want = ckpt.reference_state_dict(obj)
        got = ckpt.restore(paths[kind])
        if sorted(got) != sorted(want) or not all(torch.equal(got[k], want[k]) for k in want):
            raise AssertionError(f"the converted {kind} checkpoint differs from its .pth")
        os.remove(pth)
        del obj, want, got
        gc.collect()
    paths["flow"] = os.path.join(root, "flow", "params_latest")
    ckpt.save(paths["flow"], filled(lambda: LGUnet(cfgs.FLOW_140), 13).state_dict())
    return paths, convert_s


def check_record():
    """Phase 9: the configuration of record on its inputs; returns its
    forward launches."""
    from datetime import datetime

    import numpy as np
    import torch

    from vaevar_tpu_torch import config as cfgs
    from vaevar_tpu_torch import run_da
    from vaevar_tpu_torch.data.era5 import LocalNpyStore, ReferenceLayoutStore

    hw = cfgs.FORECAST_025.img_size
    with tempfile.TemporaryDirectory() as root:
        paths, convert_s = write_record_inputs(root)
        start = datetime(2022, 1, 1)
        readers = {"native pool": ReferenceLayoutStore(paths["era5"], hw),
                   "np.load": ReferenceLayoutStore(paths["era5"], hw, use_native=False),
                   "LocalNpyStore": LocalNpyStore(paths["era5_state"], hw)}
        read_s = {}
        for name, store in readers.items():
            secs = []
            for _ in range(3):
                t0 = time.perf_counter()
                store.get_state(start)
                secs.append(time.perf_counter() - t0)
            read_s[name] = statistics.median(secs)
        del readers
        argv = (RECORD_FLAGS + ["--vae_ckpt", paths["vae"], "--flow_ckpt", paths["flow"],
                                "--forecast_ckpt", paths["forecast"], "--data_dir",
                                paths["era5"], "--data_layout", "reference",
                                "--work_dir", os.path.join(root, "work")] + RECORD_CUT)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mark = flash_launches()
        t0 = time.perf_counter()
        da = run_da.main(argv)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = flash_launches(mark)
        peak = torch.cuda.max_memory_allocated()
        files = sorted(os.listdir(da.work_dir))
        xb = np.load(os.path.join(da.work_dir, "xb.npy"))
    phase("record", "conversions " + ", ".join(f"{k} {v:.2f} s" for k, v in convert_s.items())
          + f"; model loads {da.timings['models_s']:.2f} s; a 69 x {hw[0]}x{hw[1]} frame read "
          + ", ".join(f"{k} {v:.3f} s" for k, v in read_s.items())
          + " (medians of 3, files just written, host clock)")
    if len(da.cycle_log) != 1:
        raise AssertionError(f"{len(da.cycle_log)} record cycles; want 1")
    c = da.cycle_log[0]
    j = [b + o for b, o in zip(c["jb"], c["jo"])]
    want = (da.cfg.init_lag + 1) * 4
    phase("record", f"run_da with run_da.sh's flags, 3 checkpoints and --data_dir (reader "
          f"{da.state_source.reader}): {total:.2f} s; spin-up {da.timings['spin_up_s']:.2f} s; "
          f"cycle {c['seconds']:.2f} s (obs {c['obs_s']:.2f} s, solve {c['solve_s']:.2f} s); "
          f"J {j[0]:.6g} -> {j[-1]:.6g}, iterations {c['n_iters']}, evals {c['n_evals']}; "
          f"peak memory {peak / 2**30:.2f} GiB; flash launches (fwd, dq, dkv) {counts}")
    if da.state_source.reader != "native":
        raise AssertionError(f"the store read through {da.state_source.reader}, not the pool")
    if counts != (want, 0, 0):
        raise AssertionError(f"record run launched (fwd, dq, dkv) {counts}; want ({want}, 0, 0)")
    if not (c["xa_finite"] and c["xb_next_finite"] and np.isfinite(xb).all()):
        raise AssertionError("non-finite analysis or background in the record run")
    if not (j[-1] < j[0] and max(j) <= j[0] + 1e-6 * abs(j[0]) * c["n_iters"][-1]):
        raise AssertionError(f"the record run's solve did not lower J: {j}")
    need = {"xb.npy", "current_time.txt", "bg_wrmse.npy", "ana_wrmse.npy"}
    if not need <= set(files):
        raise AssertionError(f"missing from the record work dir: {sorted(need - set(files))}")
    return counts[0]


def micro_real_obs_problem(device, da_win=3, low=(16, 32), full=(47, 93)):
    """(cost, to_state, parts, z0, bundle) of a micro f32 real-obs window
    cost: the full-grid cost with the augmentation inside J, relbias decoder
    and flow model (block and step remat) on a 16x32 solver grid under a
    47x93 analysis grid, the 204 augmented channels, R of the channels'
    squared std (so J is well conditioned). Inputs from numpy seeds, built on
    the CPU and moved, so both devices see the same values."""
    import numpy as np
    import torch

    from vaevar_tpu_torch import channels
    from vaevar_tpu_torch import config as cfgs
    from vaevar_tpu_torch.da import cost as cost_mod
    from vaevar_tpu_torch.da import obs as obs_mod
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.ops.interp import augment_levels, obs_level_interp_matrix
    from vaevar_tpu_torch.utils.fast_init import fast_init

    dec = fast_init(LGUnet(cfgs.micro_vae_configs(img_size=low)[1].replace(remat=True)), seed=1)
    flow = fast_init(LGUnet(cfgs.micro_config(img_size=low, attn_type="relbias", remat=True)),
                     seed=2)
    dec, flow = (m.to(device).eval().requires_grad_(False) for m in (dec, flow))
    rr = np.random.default_rng(0)
    m, s = channels.MEAN.reshape(-1, 1, 1), channels.STD.reshape(-1, 1, 1)
    interp = obs_level_interp_matrix(40)
    truth = torch.as_tensor((m + s * rr.normal(size=(da_win, 69, *full))).astype(np.float32))
    std_aug = obs_mod.std_layer_augmented(40).reshape(1, -1, 1, 1)
    yo = augment_levels(truth, interp).numpy()
    arrs = ((m + s * rr.normal(size=(69, *full))),
            yo + 0.5 * std_aug * rr.normal(size=yo.shape),
            rr.random(yo.shape) < 0.3,
            std_aug ** 2 * (0.5 + rr.random((da_win, yo.shape[1], 1, 1))))
    bundle = cost_mod.ObsBundle(*(torch.as_tensor(np.asarray(a, np.float32), device=device)
                                  for a in arrs))
    cost, to_state, parts = cost_mod.make_vae4dvar_cost(dec, flow, flow_hw=low, da_win=da_win,
                                                        interp_matrix=interp)
    z0 = torch.as_tensor(0.1 * rr.standard_normal((1, 8, *low)), dtype=torch.float32,
                         device=device)
    return cost, to_state, parts, z0, bundle


def check_micro_real_obs():
    """Phase 12, micro part: one f32 real-obs window solve (da_win 3, `auto`
    linesearch) on the CPU and on the card; analyses within norm-rel 1e-5."""
    import torch

    from vaevar_tpu_torch.da.solver import VariationalSolver

    out = {}
    for dev in ("cpu", "cuda"):
        cost, to_state, parts, z0, bundle = micro_real_obs_problem(dev)
        solver = VariationalSolver(cost, to_state, parts, lbfgs_iters=4, history=4,
                                   linesearch="auto")
        x, xa, diag = solver.solve(z0, bundle, nit=2, verbose=False)
        with torch.no_grad():
            j = [float(sum(parts(q, bundle))) for q in (z0, x)]
        out[dev] = (xa.cpu(), diag, j)
    (xc, dc, _), (xg, dg, jg) = out["cpu"], out["cuda"]
    nrel = float((xg - xc).norm() / xc.norm())
    phase("real_obs", f"micro f32 real-obs window solve (da_win 3, 204 channels), card vs CPU: "
          f"linesearch {dg.linesearch}/{dc.linesearch}; iterations {dg.n_iters}/{dc.n_iters}, "
          f"evals {dg.n_evals}/{dc.n_evals}; J on the card {jg[0]:.7g} -> {jg[1]:.7g}; "
          f"analyses norm-rel {nrel:.3g} (tol 1e-5)")
    if not (nrel <= 1e-5 and jg[1] < jg[0]):
        raise AssertionError("the micro real-obs window solve on the card disagrees with the CPU "
                             "or did not lower J")


@contextlib.contextmanager
def shared_builds():
    """run_da.build_model memoised while the block runs: a later run_da with
    a role of the same config and seed (--fast_init or the flax-matched
    init, no checkpoint) takes the model the first run built, the same
    weights bit for bit (the pinned phase holds the builds to their
    digests), and skips its ~14 s full-width build. Released at exit."""
    from vaevar_tpu_torch import run_da

    build, cache = run_da.build_model, {}

    def cached(model_cfg, seed, device, fast=False, ckpt_path=None, vae=False):
        if ckpt_path:
            return build(model_cfg, seed, device, fast, ckpt_path, vae)
        key = (repr(model_cfg), seed, str(device), fast, vae)
        if key not in cache:
            cache[key] = build(model_cfg, seed, device, fast, ckpt_path, vae)
        return cache[key]

    run_da.build_model = cached
    try:
        yield
    finally:
        run_da.build_model = build
        cache.clear()


def run_da_phase(argv):
    """run_da.main(argv) in a temporary work dir with the launch counts set
    to 0 just before; returns (da, (fwd, dq, dkv) launches, seconds with the
    model set-up, peak device memory in GiB, {output file: array})."""
    import numpy as np
    import torch

    from vaevar_tpu_torch import run_da

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as work:
        mark = flash_launches()
        t0 = time.perf_counter()
        da = run_da.main(list(argv) + ["--work_dir", work])
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = flash_launches(mark)
        outs = {f: np.load(os.path.join(da.work_dir, f), allow_pickle=True)
                for f in sorted(os.listdir(da.work_dir)) if f.endswith(".npy")}
    return da, counts, total, torch.cuda.max_memory_allocated() / 2**30, outs


def check_cycle_log(name, da, want_cycles, linesearch="jvp-zoom"):
    """Per cycle: finite fields, J lowered (within the approximate-decrease
    slack of the zoom, 1e-6 |J| per iteration) and the linesearch; prints
    the cycle's seconds and, for station obs, its obs counts."""
    if len(da.cycle_log) != want_cycles:
        raise AssertionError(f"{name}: {len(da.cycle_log)} cycles; want {want_cycles}")
    for c in da.cycle_log:
        j = [b + o for b, o in zip(c["jb"], c["jo"])]
        obs = ""
        if "grid_s" in c:
            obs = (f" (truth {c['truth_s']:.2f} s, gridding {c['grid_s']:.2f} s"
                   + (f", copy + augment + QC {c['aug_qc_s']:.2f} s" if "aug_qc_s" in c else "")
                   + f"); obs gridded {c['n_gridded']:.0f}"
                   + (f", kept by QC {c['n_kept']:.0f}" if "n_kept" in c else ""))
        phase(name, f"cycle {c['time']}: {c['seconds']:.2f} s: obs {c['obs_s']:.2f} s{obs}; "
              f"solve {c['solve_s']:.2f} s; linesearch {c['linesearch'] or '-'}; iterations "
              f"{c['n_iters']}, evals {c['n_evals']}, jvp probes {c['n_jvp']}"
              + (f"; J {j[0]:.7g} -> {j[-1]:.7g}" if j else ""))
        if not (c["xa_finite"] and c["xb_next_finite"]):
            raise AssertionError(f"{name}: non-finite analysis or background at {c['time']}")
        if "n_gridded" in c and not (c["n_gridded"] > 0 and c.get("n_kept", 1) > 0):
            raise AssertionError(f"{name}: no obs gridded or kept at {c['time']}")
        if linesearch is None:
            continue
        slack = 1e-6 * abs(j[0]) * c["n_iters"][-1]
        if c["linesearch"] != linesearch or not (j[-1] < j[0] and max(j) <= j[0] + slack):
            raise AssertionError(f"{name}: linesearch {c['linesearch']}, J {j} at {c['time']}")


def compare_runs(a, b):
    """Two runs of one configuration, (da, {output file: array}) each, with
    the obs prefetch thread and without. Returns (obs equal, bitwise, worst
    norm-relative difference): the obs each cycle received (the cycle log's
    obs_checksum, n_gridded and n_kept) compared exactly; bitwise when the
    rest of the cycle log but its timings and every .npy output are equal;
    otherwise the worst |x - y| / |y| over the outputs and the J traces."""
    import numpy as np

    (da_a, outs_a), (da_b, outs_b) = a, b
    obs_keys = ("obs_checksum", "n_gridded", "n_kept")
    obs = [[{k: c.get(k) for k in obs_keys} for c in da.cycle_log] for da in (da_a, da_b)]
    logs = [[{k: v for k, v in c.items() if k not in TIMING_KEYS} for c in da.cycle_log]
            for da in (da_a, da_b)]
    pairs = [(outs_a.get(n), outs_b[n]) for n in sorted(outs_b)] + [
        (ca[k], cb[k]) for ca, cb in zip(da_a.cycle_log, da_b.cycle_log) for k in ("jb", "jo")]
    worst = 0.0
    for x, y in pairs:
        if x is None or np.shape(x) != np.shape(y):
            return obs[0] == obs[1], False, math.inf
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        if not np.array_equal(x, y):
            worst = max(worst, float(np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-30)))
    bitwise = worst == 0.0 and logs[0] == logs[1] and sorted(outs_a) == sorted(outs_b)
    return obs[0] == obs[1], bitwise, worst


def prefetch_line(da, peak):
    """Per cycle: seconds, obs preparation seconds and the loop's wait."""
    return (f"prefetch {da.prefetch_obs}: cycles "
            + "; ".join(f"{c['seconds']:.2f} s (obs {c['obs_s']:.2f} s, waited "
                        f"{c['obs_wait_s']:.2f} s)" for c in da.cycle_log)
            + f"; peak memory {peak:.2f} GiB")


def check_real_obs():
    """Phase 12: real observations and the rest of the DA surface. Returns
    the forward launches of its full-width runs, and the mesh phase's
    reference: the prefetch run's cycle 1 (its log entry and metric rows)
    and the peak memory of both runs."""
    import numpy as np
    import torch

    from vaevar_tpu_torch import config as cfgs

    per_step = cfgs.FORECAST_025.lg_depths[0]
    serial, counts_s, total, peak_s, outs_s = run_da_phase(REAL_OBS_ARGS + ["--no_prefetch"])
    want = (serial.cfg.init_lag + len(serial.cycle_log)) * per_step
    phase("real_obs", f"--no_prefetch: {total:.2f} s with the models; "
          + prefetch_line(serial, peak_s) + f"; flash launches (fwd, dq, dkv) {counts_s}")
    check_cycle_log("real_obs --no_prefetch", serial, 2)
    if counts_s != (want, 0, 0):
        raise AssertionError(f"real_obs --no_prefetch launched {counts_s}; want ({want}, 0, 0)")
    second = (SimpleNamespace(cycle_log=serial.cycle_log), outs_s)
    del serial, outs_s  # the models, before the prefetch run's peak is read
    gc.collect()
    torch.cuda.empty_cache()

    with shared_builds():  # the prepbufr and free_run runs take the prefetch run's models
        da, counts, total, peak, outs = run_da_phase(REAL_OBS_ARGS)
        err = outs.get("error_obs.npy")
        phase("real_obs", f"real_simu --use_eval, 2000 synthetic stations: "
              f"{len(da.cycle_log)} cycles in {total:.2f} s (models "
              f"{da.timings['models_s']:.2f} s); spin-up {da.timings['spin_up_s']:.2f} s; cycles "
              + ", ".join(f"{v:.2f}" for v in da.timings["cycle_s"]) + f" s; peak memory "
              f"{peak:.2f} GiB; error_obs {None if err is None else err.shape}; flash launches "
              f"(fwd, dq, dkv) {counts}")
        check_cycle_log("real_obs", da, 2)
        if counts != (want, 0, 0):
            raise AssertionError(f"real_obs launched (fwd, dq, dkv) {counts}; want ({want}, 0, 0)")
        if err is None or err.shape != (2, 204) or not np.isfinite(err).all():
            raise AssertionError(f"error_obs.npy: {None if err is None else err.shape}; "
                                 "want (2, 204)")
        launches = counts[0] + counts_s[0]
        ref = {"cycle": da.cycle_log[0], "peak": peak, "peak_serial": peak_s,
               **{k: outs[f"{k}.npy"][0] for k in ("ana_wrmse", "bg_wrmse", "error_obs")}}
        if not da.prefetch_obs:
            raise AssertionError("run_da ran without the obs prefetch thread by default")
        phase("real_obs", prefetch_line(da, peak))
        obs_equal, bitwise, worst = compare_runs((da, outs), second)
        phase("real_obs", f"prefetch vs --no_prefetch: obs received equal in every cycle: "
              f"{obs_equal}; cycle logs, metrics and xb.npy bitwise equal: {bitwise}; worst "
              f"norm-rel difference {worst:.3g}")
        if not (obs_equal and bitwise):
            raise AssertionError("the prefetch and --no_prefetch runs disagree")
        del da, outs, second

        da, counts, total, peak, _ = run_da_phase(ONE_CYCLE + ["--obs_type", "prepbufr"] + CUT)
        phase("real_obs", f"prepbufr, 1 cycle from the truth: {total:.2f} s with the models; peak "
              f"memory {peak:.2f} GiB; flash launches (fwd, dq, dkv) {counts}")
        check_cycle_log("prepbufr", da, 1)
        if counts != (per_step, 0, 0):
            raise AssertionError(f"prepbufr launched {counts}; want ({per_step}, 0, 0)")
        launches += counts[0]
        del da

        argv = ["--da_mode", "free_run"] + ONE_CYCLE[2:] + ["--forecast_eval",
                                                             "--forecast_eval_steps", "2"]
        da, counts, total, peak, outs = run_da_phase(argv)
        fw = outs.get("forecast_wrmse.npy")
        phase("real_obs", f"free_run --forecast_eval_steps 2: {total:.2f} s with the models; peak "
              f"memory {peak:.2f} GiB; decoder built {da.decoder is not None}; forecast_wrmse "
              f"{None if fw is None else fw.shape}, z500 at +6 h and +12 h "
              f"{None if fw is None else fw[0, :, 11]}; flash launches (fwd, dq, dkv) {counts}")
        check_cycle_log("free_run", da, 1, linesearch=None)
        if counts != (3 * per_step, 0, 0) or da.decoder is not None:
            raise AssertionError(f"free_run launched {counts}; want ({3 * per_step}, 0, 0)")
        if fw is None or fw.shape != (1, 2, 69) or not np.isfinite(fw).all():
            raise AssertionError(f"forecast_wrmse.npy: {None if fw is None else fw.shape}")
        launches += counts[0]
        del da, outs

        check_micro_real_obs()
        argv = ["--micro", "--fast_init", "--grid", "32x64", "--solver_grid", "32x64",
                "--init_lag", "1", "--end_time", "2022-01-01 06:00:00", "--da_mode",
                "interpolation", "--obs_type", "real_simu", "--use_eval"]
        da, counts, total, _, outs = run_da_phase(argv)
        err = outs.get("error_obs.npy")
        phase("real_obs", f"interpolation, real_simu --use_eval at 32x64 (micro): {total:.2f} s; "
              f"griddata {da.cycle_log[0]['solve_s']:.2f} s on the host; error_obs "
              f"{None if err is None else err.shape}; ana z500 "
              f"{outs['ana_wrmse.npy'][0, 11]:.6g} vs bg {outs['bg_wrmse.npy'][0, 11]:.6g}")
        check_cycle_log("interpolation", da, 1, linesearch=None)
        if err is None or err.shape != (1, 204) or not np.isfinite(err).all():
            raise AssertionError("interpolation: error_obs.npy missing or not finite")
    return launches, ref


def check_osse():
    """Phase 13: the OSSE (vaevar_tpu_torch/osse.py) on the card: the micro
    VAE trained 120 epochs on the world's NMC errors, then free_run,
    vae4dvar, sc4dvar and the da_win 3 window cycled for 2 days at 32x64,
    every bound of tests/test_osse_science.py checked."""
    import torch

    from vaevar_tpu_torch import osse

    from vaevar_tpu_torch.train.vae_trainer import replicated_checksum

    world = osse.build_world("cuda")
    h = world.history
    phase("osse", f"micro VAE trained {len(h)} steps (120 epochs of 6, deterministic algorithms) "
          f"in {world.train_s:.2f} s: loss {h[0]['loss']:.6g} -> {h[-1]['loss']!r} (ratio "
          f"{h[-1]['loss'] / h[0]['loss']:.4f}, bound 0.35); decoder checksum "
          f"{replicated_checksum(world.decoder)!r}")
    if not h[-1]["loss"] < 0.35 * h[0]["loss"]:
        raise AssertionError("the OSSE's VAE did not learn its error distribution")
    with tempfile.TemporaryDirectory() as root:
        cycled = osse.run_cycles(world, root, device="cuda")
    phase("osse", "seconds per 2-day run: " + ", ".join(
        f"{m} {v[2]:.2f}" for m, v in cycled.items()))
    rows = osse.ratios(cycled)
    for name, v, b in rows:
        phase("osse", f"{name} {v!r} ({'>=' if 'share' in name else '<'} {b})")
    osse.check(cycled)
    del world
    gc.collect()
    torch.cuda.empty_cache()


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def start_workers(flag, n, argv):
    """n worker processes `python3 chip_smoke.py <flag> <argv...>` with
    RANK 0..n-1 and LOCAL_RANK 0 (all on the one card), a rendezvous on a
    free port, started; their output goes to temporary files."""
    env = dict(os.environ, WORLD_SIZE=str(n), LOCAL_RANK="0", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()))
    logs = [tempfile.TemporaryFile("w+") for _ in range(n)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, *argv],
                              env=dict(env, RANK=str(r)), stdout=log,
                              stderr=subprocess.STDOUT, text=True) for r, log in enumerate(logs)]
    # a failure elsewhere in the smoke leaves none of them running
    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])
    return SimpleNamespace(flag=flag, procs=procs, logs=logs, t0=time.perf_counter())


def wait_workers(started, timeout):
    """Wait for workers that start_workers started; kills them all if one
    is not done in `timeout` s, raises with the log of a failed one;
    returns the seconds since their start."""
    try:
        for p in started.procs:
            p.wait(timeout=max(1.0, started.t0 + timeout - time.perf_counter()))
    finally:
        for p in started.procs:
            p.kill()
            p.wait()
    started.texts = []
    for log in started.logs:
        log.seek(0)
        started.texts.append(log.read())
        log.close()
    for p, text in zip(started.procs, started.texts):
        if p.returncode != 0:
            raise AssertionError(f"{started.flag} worker failed ({p.returncode}):\n"
                                 f"{text[-6000:]}")
    return time.perf_counter() - started.t0


def launch_workers(flag, n, argv, timeout):
    """start_workers, then wait_workers: returns the seconds."""
    return wait_workers(start_workers(flag, n, argv), timeout)


def dp_worker(d):
    """One rank of the dp phase: 2 ranks on the one card over gloo (nccl
    refuses two ranks on one device). (a) FORECAST_025 at full width, b1
    per rank, bf16, remat, Possloss: 2 DDP steps with their seconds and
    launches, the ranks' checksums compared, then the gradient all-reduce
    alone; (b) one micro f32 DDP step, whose loss and gradients the parent
    holds against a dp=1 step on the global batch. Writes rank<r>.json and
    micro<r>.pt under `d`."""
    from datetime import datetime, timedelta

    import numpy as np
    import torch
    import torch.distributed as dist

    from vaevar_tpu_torch import channels
    from vaevar_tpu_torch import config as cfgs
    from vaevar_tpu_torch.data.era5 import SyntheticEra5
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.parallel import mesh as pmesh
    from vaevar_tpu_torch.train import forecast_trainer as ft

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = pmesh.init_distributed(backend="gloo", device="cuda")
    mesh = pmesh.mesh_from_arg("2", "cuda")
    out = {"rank": rank, "device": str(mesh.device), "backend": dist.get_backend()}

    t0 = time.perf_counter()
    cfg = cfgs.FORECAST_025.replace(dtype=torch.bfloat16)  # remat on
    model = filled(lambda: LGUnet(cfg), 0).to(mesh.device).train()
    hw = cfg.img_size
    src = SyntheticEra5(hw=hw, seed=0)
    mean, std = channels.MEAN.reshape(-1, 1, 1), channels.STD.reshape(-1, 1, 1)
    t = datetime(2022, 1, 1) + rank * timedelta(hours=6)  # this rank's row of the global batch
    inp, tar = (torch.from_numpy(((src.get_state(ts) - mean) / std).astype(np.float32)[None])
                .to(mesh.device) for ts in (t, t + timedelta(hours=6)))
    init_fn, step = ft.make_forecast_train_step(model, "Possloss", lr=LR,
                                                total_steps=TOTAL_STEPS,
                                                out_shape=(2 * channels.N_CHANNELS, *hw),
                                                mesh=mesh)
    trainable, opt_state = init_fn()
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    out.update(losses=[], secs=[], launches=[])
    for _ in range(2):
        dist.barrier()
        mark = flash_launches()
        t0 = time.perf_counter()
        trainable, opt_state, loss = step(trainable, opt_state, inp, [tar])
        out["losses"].append(loss.item())
        torch.cuda.synchronize()
        out["secs"].append(time.perf_counter() - t0)
        out["launches"].append(list(flash_launches(mark)))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["checksum"] = ft.trainable_checksum(trainable)
    pmesh.check_replicas(out["checksum"])
    # the all-reduce alone: the last step's gradients (model and bounds)
    # summed over the ranks the way DDP's buckets are, not overlapped
    grads = [p.grad for p in ft.trainable_parameters(trainable)]
    out["grad_bytes"] = sum(g.numel() * g.element_size() for g in grads)
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flat = torch.cat([g.flatten() for g in grads])
    for chunk in flat.split(25 * 2 ** 20 // 4):
        dist.all_reduce(chunk)
    torch.cuda.synchronize()
    out["allreduce_s"] = time.perf_counter() - t0
    del model, trainable, opt_state, grads, flat, step, init_fn
    gc.collect()
    torch.cuda.empty_cache()

    # (b) one micro f32 step on this rank's row of the parent's global batch
    batch = torch.load(os.path.join(d, "micro_batch.pt"))
    micro = micro_model(remat=True).to(mesh.device).train()
    init_fn, step = ft.make_forecast_train_step(micro, "Possloss", lr=1e-4, total_steps=10,
                                                out_shape=(138, 32, 64), mesh=mesh)
    trainable, opt_state = init_fn()
    x, y = (batch[k][rank:rank + 1].to(mesh.device) for k in ("inp", "tar"))
    _, _, loss = step(trainable, opt_state, x, [y])
    torch.save({"loss": loss.item(), "grads": torch.cat(
        [p.grad.flatten() for p in ft.trainable_parameters(trainable)]).cpu()},
        os.path.join(d, f"micro{rank}.pt"))
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def check_dp(single_step_s):
    """Phase 14: data-parallel training (parallel/mesh.py, DDP). (a) and (b)
    in 2 worker processes on the one card over gloo (`dp_worker`), (b)'s
    dp=1 reference on the global batch here; (c) run_train_forecast --mesh 1
    through torch.distributed.run with nccl. Returns the launch counts of
    (a), summed over the ranks."""
    import numpy as np
    import torch

    from vaevar_tpu_torch.train import forecast_trainer as ft

    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(6)
    batch = {k: torch.from_numpy(rng.standard_normal((2, 69, 32, 64), dtype=np.float32))
             for k in ("inp", "tar")}
    with tempfile.TemporaryDirectory() as d:
        torch.save(batch, os.path.join(d, "micro_batch.pt"))
        wall = launch_workers("--dp-worker", 2, [d], 600)
        ranks = [json.load(open(os.path.join(d, f"rank{r}.json"))) for r in range(2)]
        micro = [torch.load(os.path.join(d, f"micro{r}.pt")) for r in range(2)]

    for r in ranks:
        phase("dp", f"(a) rank {r['rank']} on {r['device']} ({r['backend']}): FORECAST_025 "
              f"721x1440 b1 per rank bf16 remat, set-up {r['setup_s']:.2f} s; losses "
              + ", ".join(f"{v:.6g}" for v in r["losses"]) + "; seconds "
              + ", ".join(f"{v:.3f}" for v in r["secs"]) + f"; peak memory "
              f"{r['peak_gib']:.2f} GiB; launches per step (fwd, dq, dkv) {r['launches']}; "
              f"checksum {r['checksum']!r}")
    r0 = ranks[0]
    share = r0["allreduce_s"] / r0["secs"][-1]
    phase("dp", f"(a) gradient all-reduce alone (gloo, {r0['grad_bytes'] / 1e9:.2f} GB of f32 "
          f"gradients, model and logvar bounds): {r0['allreduce_s']:.3f} s, {100 * share:.1f} % "
          f"of the dp step {r0['secs'][-1]:.3f} s; the single-process b1 step "
          f"{single_step_s:.3f} s; {wall:.1f} s with the workers' start")
    bad = [r for r in ranks if any(tuple(c) != (8, 4, 4) for c in r["launches"])
           or not all(np.isfinite(r["losses"]))]
    if bad or ranks[0]["checksum"] != ranks[1]["checksum"] or \
            ranks[0]["losses"] != ranks[1]["losses"]:
        raise AssertionError(f"dp run: launches, losses or checksums wrong: {ranks}")

    # (b) the dp=1 step on the global batch, here
    micro_ref = micro_model(remat=True).cuda().train()
    init_fn, step = ft.make_forecast_train_step(micro_ref, "Possloss", lr=1e-4, total_steps=10,
                                                out_shape=(138, 32, 64))
    trainable, opt_state = init_fn()
    _, _, loss = step(trainable, opt_state, batch["inp"].cuda(), [batch["tar"].cuda()])
    g = torch.cat([p.grad.flatten() for p in ft.trainable_parameters(trainable)]).cpu()
    scale = g.abs().max().item()
    lerr = max(abs(m["loss"] - loss.item()) / abs(loss.item()) for m in micro)
    gerr = max((m["grads"] - g).abs().max().item() for m in micro)
    phase("dp", f"(b) micro f32 dp=2 step vs dp=1 on the global batch, on the card: loss "
          f"{micro[0]['loss']:.7g} vs {loss.item():.7g} (rel {lerr:.3g}, tol 1e-5); gradients "
          f"max|d| {gerr:.3g} <= {1e-3 * scale:.3g} (1e-3 x max|grad|)")
    if not (lerr <= 1e-5 and gerr <= 1e-3 * scale):
        raise AssertionError("the dp=2 micro step disagrees with dp=1 on the global batch")
    del micro_ref, trainable, opt_state
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the CLI through torch.distributed.run, nccl, world size 1
    with tempfile.TemporaryDirectory() as out:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
               "--nproc_per_node", "1", "--master_addr", "localhost", "--master_port",
               str(_free_port()), "-m", "vaevar_tpu_torch.run_train_forecast", "--mesh", "1",
               "--micro", "--grid", "32x64", "--batch_size", "2", "--steps", "2",
               "--end_time", "2022-01-04 00:00:00", "--out_dir", out, "--log_every", "1"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        files = set(os.listdir(out))
        log = open(os.path.join(out, "run.log")).read() if "run.log" in files else ""
    nccl = "mesh: dp 1, rank 0 on cuda:0 (nccl)" in log
    phase("dp", f"(c) torch.distributed.run --nproc_per_node 1 run_train_forecast --mesh 1: "
          f"exit {proc.returncode} in {time.perf_counter() - t0:.1f} s; nccl process group "
          f"{nccl}; files {sorted(files)}")
    if proc.returncode != 0 or not nccl or "params_latest" not in files:
        raise AssertionError(f"the nccl CLI run failed:\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-4000:]}")
    counts = np.sum([r["launches"] for r in ranks], axis=(0, 1))
    return dict(zip(("flash_fwd", "flash_dq", "flash_dkv"), map(int, counts)))


# the spatial_train phase's tolerances for (b), the production VAE at 1x1x2 in
# bf16 against the vae_train phase's single process (see check_spatial_train)
SPATIAL_LOSS_TOL = (2 ** -7, 2 ** -6)  # relative, steps 1 and 2
SPATIAL_NORM_TOL = (2 ** -6, 2 ** -8)  # rel of each tensor, of the largest norm
ADAM_REACH = 4.01  # lr: two runs' parameters after 2 Adam steps differ by at most this
# (a)'s micro VAE with 2 blocks per stage, so that its odd blocks shift and
# their halos cross both axes of the 1x2x2 mesh
SPATIAL_MICRO = dict(enc_depths=(2, 2), lg_depths=(2,))


def spatial_worker(d, part):
    """One rank of the spatial_train phase, on the one card over gloo.
    `micro`: the micro f32 VAE step of vae_step_on (SPATIAL_MICRO) at
    --mesh 1x2x2 (4 ranks) on its tile of the parent's frames and noise;
    writes its loss, its gradients and its halo exchanges. `prod`: run_train_vae's defaults (FLOW_140 and VAE_ENCODER +
    VAE_DECODER at 128x256, bf16, remat, b8) at --mesh 1x1x2 (2 ranks), 2
    train_vae steps on the vae_train phase's batch and noise; writes its
    metrics, step seconds, peak memory, the halo exchanges of step 2 (bytes
    and seconds), the gradient all-reduce alone, the step-1 gradient norms
    and (rank 0) the parameters' distance from the single process's after
    step 2. Writes <part><rank>.json under `d`."""
    import torch
    import torch.distributed as dist

    from vaevar_tpu_torch import config as cfgs
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.models.vae import VAE
    from vaevar_tpu_torch.parallel import mesh as pmesh
    from vaevar_tpu_torch.parallel import spatial
    from vaevar_tpu_torch.train import vae_trainer as vt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = pmesh.init_distributed(backend="gloo", device="cuda")
    mesh = pmesh.mesh_from_arg("1x2x2" if part == "micro" else "1x1x2", "cuda")
    dev = mesh.device
    out = {"rank": rank, "device": str(dev), "coords": mesh.coords}
    mark = flash_launches()
    halo, halo_s = [], []  # this rank's strip in each exchange: bytes, seconds
    gather = spatial._all_gather

    def timed_gather(t, group=None):
        torch.cuda.synchronize()  # the exchange's own time, not the queue's
        t0 = time.perf_counter()
        parts = gather(t, group)
        halo_s.append(time.perf_counter() - t0)
        halo.append(t.numel() * t.element_size())
        return parts

    spatial._all_gather = timed_gather
    if part == "micro":
        data = torch.load(os.path.join(d, "micro.pt"))
        loss, grads = vae_step_on(dev, data["frames"], data["eps"], mesh, **SPATIAL_MICRO)
        out.update(loss=loss, grads=grads.tolist(), halo=len(halo))
    else:
        from vaevar_tpu_torch.data.era5 import SyntheticEra5
        from vaevar_tpu_torch.data.nmc import NMCSequenceDataset, batched_loader

        t0 = time.perf_counter()
        hw, dt = (128, 256), torch.bfloat16
        flow_cfg, enc_cfg, dec_cfg = (c.replace(img_size=hw, dtype=dt, remat=True)
                                      for c in (cfgs.FLOW_140, cfgs.VAE_ENCODER, cfgs.VAE_DECODER))
        flow = filled(lambda: LGUnet(flow_cfg), 0).to(dev).eval().requires_grad_(False)
        vae = filled(lambda: VAE(enc_cfg, dec_cfg), 1).to(dev)
        ds = NMCSequenceDataset(SyntheticEra5(hw=hw, seed=0), START, "2022-02-01 00:00:00")
        batch = next(batched_loader(ds, 8, seed=0))
        torch.cuda.synchronize()
        out["setup_s"] = time.perf_counter() - t0
        marks, norms, halos = [], [], []

        def log(msg):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if " iter 0 " in msg:
                norms.append(torch.stack([p.grad.float().norm() for p in vae.parameters()])
                             .cpu().tolist())
            halos.append((list(halo), sum(halo_s)))
            halo.clear()
            halo_s.clear()
            marks.append((t, time.perf_counter()))  # a step's end, the next one's start

        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        t0 = time.perf_counter()
        _, hist = vt.train_vae(vae, flow, [batch] * 2, epochs=1, logger=log, log_every=1,
                               latent_hw=hw, mesh=mesh)
        torch.cuda.synchronize()
        out.update(peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   secs=[end - start for start, (end, _) in zip([t0, marks[0][1]], marks[:2])])
        # the gradient all-reduce alone: the last step's gradients summed again
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pmesh.all_sum_grads(vae.parameters())
        torch.cuda.synchronize()
        rows, cols = mesh.tiling.tile(hw)
        out.update(allreduce_s=time.perf_counter() - t0, checksum=vt.replicated_checksum(vae),
                   hist=hist, grad_norms=norms[0], halo_step2=halos[1][0],
                   halo_step2_s=halos[1][1], n_vae=sum(p.numel() for p in vae.parameters()),
                   batch_tile=list(batch[..., rows, cols].shape))
        if rank == 0:  # the ranks are bitwise equal (train_vae's replica check)
            want = torch.load(os.path.join(d, "prod_params.pt"), mmap=True)
            moved = far = 0
            for k, v in vae.state_dict().items():
                diff = (v.detach().cpu() - want[k]).abs()
                moved = max(moved, float(diff.max()))
                far += int((diff > 0.5e-4).sum())
            out.update(max_param_diff=moved, share_beyond_half_lr=far / out["n_vae"])
    out["launches"] = list(flash_launches(mark))
    with open(os.path.join(d, f"{part}{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def start_spatial_train(ref):
    """Phase 17's workers, started beside the real_obs phase:
    (a) 4 `--spatial-worker micro` ranks and (b) 2 `--spatial-worker prod`
    ranks, all on the one card over gloo, with the vae_train phase's micro
    inputs and the parameters of its single process after step 2 written
    to their directory."""
    import torch

    d = tempfile.mkdtemp(prefix="spatial_train")
    atexit.register(shutil.rmtree, d, True)
    torch.save(ref["micro"], os.path.join(d, "micro.pt"))
    torch.save(ref.pop("params"), os.path.join(d, "prod_params.pt"))
    return d, (start_workers("--spatial-worker", 4, [d, "micro"]),
               start_workers("--spatial-worker", 2, [d, "prod"]))


def check_spatial_train(started, ref):
    """Phase 17: the VAE trainer's spatial mesh (run_train_vae --mesh
    DPxSHxSW: LGUnet.partition, the halo exchanges of parallel/spatial.py,
    the gradients summed over the ranks), its workers started by
    start_spatial_train. (a) the micro f32 step at 1x2x2 on 4 ranks against
    the one process on the card (vae_train phase): loss rel 1e-5, gradients
    1e-3 x max|grad| (f32 sums in other orders, as the micro card-vs-CPU
    step), the ranks bitwise equal. (b) the production VAE at 1x1x2, b8
    bf16 remat, 2 train_vae steps on 2 ranks against the vae_train phase's
    first 2 steps on the same batch and noise. The tile changes the GEMMs'
    shapes, and so which bf16 products round where; the tolerances, with
    their reasons: loss, rec and kld of step 1 within 2^-7 relative (sums
    of non-negative squares and KL terms, each computed from bf16 outputs
    that may round one ulp, 2^-8, apart: at most two ulps of a term), of
    step 2 within 2^-6 (it starts from parameters that differ by up to 2 lr
    where step 1's gradient was within round-off of zero); each tensor's
    step-1 gradient norm within 2^-6 of its own plus 2^-8 of the largest
    (the weight gradients are bf16 GEMM outputs, rounded per rank and then
    summed, back-propagated through bf16 layers; a norm averages over the
    tensor); the parameters after step 2 within 4.01 lr (Adam's reach: two
    runs move a parameter at most 2.0014 lr apart per step, so more is no
    Adam step of equal parameters); the ranks bitwise equal. Prints each
    rank's peak memory beside the single process's, its step seconds, the
    halo exchanges of step 2 (count, bytes of one and in all, seconds) and
    the gradient all-reduce alone."""
    import numpy as np
    import torch

    d, (micro, prod) = started
    try:
        wall = [wait_workers(w, 600) for w in (micro, prod)]
        ranks = {part: [json.load(open(os.path.join(d, f"{part}{r}.json"))) for r in range(n)]
                 for part, n in (("micro", 4), ("prod", 2))}
    finally:
        for w in (micro, prod):
            for p in w.procs:
                p.kill()
    l1, g1 = vae_step_on("cuda", ref["micro"]["frames"], ref["micro"]["eps"], **SPATIAL_MICRO)
    scale = g1.abs().max().item()
    errs = [(abs(r["loss"] - l1) / abs(l1), (torch.tensor(r["grads"]) - g1).abs().max().item())
            for r in ranks["micro"]]
    same = all(r["grads"] == ranks["micro"][0]["grads"] and r["loss"] == ranks["micro"][0]["loss"]
               for r in ranks["micro"])
    phase("spatial_train", f"(a) micro f32 VAE step at --mesh 1x2x2, 4 ranks on the card over "
          f"gloo, vs one process on the card: loss {ranks['micro'][0]['loss']:.7g} vs "
          f"{l1:.7g} (rel {max(e[0] for e in errs):.3g}, tol 1e-5); gradients max|d| "
          f"{max(e[1] for e in errs):.3g} <= {1e-3 * scale:.3g} (1e-3 x max|grad|); ranks "
          f"bitwise equal {same}; halo exchanges per rank {[r['halo'] for r in ranks['micro']]}; "
          f"flash launches {ranks['micro'][0]['launches']}; {wall[0]:.1f} s with the workers' "
          "start")
    if not (same and all(e[0] <= 1e-5 and e[1] <= 1e-3 * scale for e in errs)
            and all(r["halo"] > 0 and r["launches"] == [0, 0, 0] for r in ranks["micro"])):
        raise AssertionError("the 1x2x2 micro VAE step disagrees with one process")

    single = ref["hist"][:2]
    r0 = ranks["prod"][0]
    phase("spatial_train", f"(b) run_train_vae's defaults at --mesh 1x1x2: VAE_ENCODER + "
          f"VAE_DECODER {r0['n_vae'] / 1e6:.1f} M, FLOW_140, b8 128x256 bf16 remat; each rank's "
          f"frames tile {r0['batch_tile']}")
    for r in ranks["prod"]:
        halo = r["halo_step2"]
        phase("spatial_train", f"(b) rank {r['rank']} on {r['device']} (gloo): set-up "
              f"{r['setup_s']:.2f} s; step seconds " + ", ".join(f"{v:.3f}" for v in r["secs"])
              + f"; peak memory {r['peak_gib']:.2f} GiB against {ref['peak_gib']:.2f} GiB in "
              f"one process (11.94 GiB, PERF.md section 5); step 2's halo exchanges: "
              f"{len(halo)}, {min(halo, default=0)}-{max(halo, default=0)} bytes each "
              f"(this rank's strip), {sum(halo) / 1e6:.3f} MB in all, "
              f"{r['halo_step2_s']:.3f} s (each from a synchronized start); the gradient "
              f"all-reduce alone (gloo, {4 * r['n_vae'] / 1e9:.2f} GB of f32) "
              f"{r['allreduce_s']:.3f} s; flash launches {r['launches']}; checksum "
              f"{r['checksum']!r}")
    lerr = [max(abs(h[k] - s[k]) / abs(s[k]) for k in ("loss", "rec_sse", "kld"))
            for h, s in zip(r0["hist"], single)]
    n1, n2 = np.asarray(ref["grad_norms"].tolist()), np.asarray(r0["grad_norms"])
    nerr = np.abs(n2 - n1) - (SPATIAL_NORM_TOL[0] * n1 + SPATIAL_NORM_TOL[1] * n1.max())
    lr = 1e-4
    phase("spatial_train", "(b) vs the vae_train phase's single process, steps 1-2: losses "
          + ", ".join(f"{h['loss']:.7g} vs {s['loss']:.7g}" for h, s in zip(r0["hist"], single))
          + f"; max rel (loss, rec, kld) per step " + ", ".join(f"{e:.3g}" for e in lerr)
          + f" (tol 2^-7, 2^-6); step-1 gradient norms: max rel "
          f"{np.max(np.abs(n2 - n1) / np.maximum(n1, 1e-30)):.3g}, worst margin {nerr.max():.3g} "
          f"(<= 0: within 2^-6 of each + 2^-8 of the largest, {n1.max():.4g}); parameters "
          f"after step 2 max|d| {r0['max_param_diff']:.3g} <= {ADAM_REACH * lr:.3g} "
          f"({ADAM_REACH} lr), {100 * r0['share_beyond_half_lr']:.3f} % beyond lr/2; "
          f"{wall[1]:.1f} s with the workers' start")
    bad = [r for r in ranks["prod"] if r["launches"] != [0, 0, 0] or not r["halo_step2"]
           or r["hist"] != r0["hist"] or r["checksum"] != r0["checksum"]]
    if bad or not (lerr[0] <= SPATIAL_LOSS_TOL[0] and lerr[1] <= SPATIAL_LOSS_TOL[1]
                   and (nerr <= 0).all() and r0["max_param_diff"] <= ADAM_REACH * lr
                   and all(np.isfinite([h["loss"] for h in r0["hist"]]))):
        raise AssertionError("the 1x1x2 production VAE steps disagree with one process, or "
                             "the ranks differ")


# the spatial_forecast phase's (a): the CPU tests' rope micro at 16x48 (LG
# stages (1, 2): a full-grid stage 0 and a windowed, shifted stage 1 on a 4x12
# grid whose 3 window columns sw=2 cuts into 8 + 4 window-aligned columns;
# tests/test_torch_spatial_forecast.py) at widths the flash kernels take (head
# dims 32 and 64) and flash_min_seq 48, so that stage 0 launches them
FORECAST_MICRO = dict(img_size=(16, 48), lg_depths=(1, 2), lg_heads=(2, 2), enc_dim=32,
                      embed_dim=64, flash_min_seq=48, inchans_list=(4, 13),
                      outchans_list=(8, 26), remat=True)


def forecast_micro_step(dev, batch, mesh=None):
    """One micro f32 Possloss step (FORECAST_MICRO, b2) on `dev`, or with a
    TrainMesh on this rank's dp rows and tile of the batch (the model
    partitioned, the gradients summed over the ranks); returns (loss, the
    trainable's gradients as one CPU vector, the flash launches)."""
    import torch

    from vaevar_tpu_torch import config as cfgs
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.train import forecast_trainer as ft
    from vaevar_tpu_torch.utils.fast_init import fast_init

    cfg = cfgs.micro_config(**FORECAST_MICRO)
    model = fast_init(LGUnet(cfg), seed=3).to(dev).train()
    init_fn, step = ft.make_forecast_train_step(model, "Possloss", lr=1e-4, total_steps=10,
                                                out_shape=(34, *cfg.img_size), mesh=mesh)
    trainable, opt_state = init_fn()
    x, y = batch["inp"], batch["tar"]
    if mesh is not None:
        lo, hi = mesh.batch_spec(2 // mesh.dp)
        rows, cols = mesh.tiling.tile(cfg.img_size)
        x, y = x[lo:hi, :, rows, cols], y[lo:hi, :, rows, cols]
    mark = flash_launches()
    _, _, loss = step(trainable, opt_state, x.to(dev), [y.to(dev)])
    grads = torch.cat([p.grad.flatten() for p in ft.trainable_parameters(trainable)]).cpu()
    return loss.item(), grads, list(flash_launches(mark))


def spatial_forecast_worker(d, part):
    """One rank of the spatial_forecast phase, on the one card over gloo.
    `prod` (2 ranks, --mesh 1x1x2): FORECAST_025 at 721x1440, b1, bf16,
    remat, Possloss, the train phase's model, inputs, lr and schedule, 2
    train steps on this rank's lon tile; writes the losses, the step
    seconds, the launches and the exchanges (count, bytes, seconds; by
    kind: halo roll, retile, the full-grid stage's gather and its
    backward's all-reduce) of each step, the step-1 gradient norms, the
    peak memory, the gradient all-reduce alone and (rank 0) the parameters'
    distance from the train phase's after step 2; then (a)'s micro step at
    1x1x2. `micro` (4 ranks, --mesh 2x1x2): (a)'s micro step. Writes
    <part><rank>.json and the micro gradients micro_<mesh>_<rank>.pt under
    `d`."""
    import torch
    import torch.distributed as dist

    from vaevar_tpu_torch import channels
    from vaevar_tpu_torch import config as cfgs
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.parallel import mesh as pmesh
    from vaevar_tpu_torch.parallel import spatial
    from vaevar_tpu_torch.train import forecast_trainer as ft

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = pmesh.init_distributed(backend="gloo", device="cuda")
    arg = "2x1x2" if part == "micro" else "1x1x2"
    mesh = pmesh.mesh_from_arg(arg, "cuda")
    dev = mesh.device
    out = {"rank": rank, "device": str(dev), "coords": mesh.coords}
    batch = torch.load(os.path.join(d, "micro_batch.pt"))
    if part == "prod":
        # each exchange by kind: (bytes this rank sends, seconds from a
        # synchronized start)
        kind, log = [None], {"halo": [], "retile": [], "gather": [], "gather_bwd": []}

        def tagged(name, fn):
            def call(*a):
                kind.append(name)
                try:
                    return fn(*a)
                finally:
                    kind.pop()
            return call

        def timed(name, fn):
            def call(t, group=None):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = fn(t, group)
                log.setdefault(name or kind[-1] or "other", []).append(
                    (t.numel() * t.element_size(), time.perf_counter() - t0))
                return got
            return call

        spatial._move = tagged("retile", spatial._move)
        spatial._roll = tagged("halo", spatial._roll)
        spatial.Tiling._gather_whole = tagged("gather", spatial.Tiling._gather_whole)
        spatial._all_gather = timed(None, spatial._all_gather)
        spatial.all_sum = timed("gather_bwd", spatial.all_sum)

        t0 = time.perf_counter()
        cfg = cfgs.FORECAST_025.replace(dtype=torch.bfloat16)  # remat on
        model = filled(lambda: LGUnet(cfg), 0).to(dev).train()
        hw = cfg.img_size
        rows, cols = mesh.tiling.tile(hw)
        ref = torch.load(os.path.join(d, "train_inputs.pt"))
        inp, tar = (ref[k][..., rows, cols].contiguous().to(dev) for k in ("inp", "tar"))
        init_fn, step = ft.make_forecast_train_step(model, "Possloss", lr=LR,
                                                    total_steps=TOTAL_STEPS,
                                                    out_shape=(2 * channels.N_CHANNELS, *hw),
                                                    mesh=mesh)
        trainable, opt_state = init_fn()
        torch.cuda.synchronize()
        out.update(setup_s=time.perf_counter() - t0, tile=list(inp.shape),
                   layout=str(model.net.layout), losses=[], secs=[], launches=[],
                   exchanges=[])
        torch.cuda.reset_peak_memory_stats()
        for k in range(2):
            dist.barrier()
            for v in log.values():
                v.clear()
            mark = flash_launches()
            t0 = time.perf_counter()
            trainable, opt_state, loss = step(trainable, opt_state, inp, [tar])
            out["losses"].append(loss.item())
            torch.cuda.synchronize()
            out["secs"].append(time.perf_counter() - t0)
            out["launches"].append(list(flash_launches(mark)))
            out["exchanges"].append({name: [len(v), sum(b for b, _ in v),
                                            min((b for b, _ in v), default=0),
                                            max((b for b, _ in v), default=0),
                                            sum(s for _, s in v)]
                                     for name, v in log.items()})
            if k == 0:
                out["norms"] = [float(p.grad.float().norm())
                                for p in ft.trainable_parameters(trainable)]
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["checksum"] = ft.trainable_checksum(trainable)
        pmesh.check_replicas(out["checksum"])
        # the all-reduce alone: the last step's gradients summed again
        params = ft.trainable_parameters(trainable)
        out["grad_bytes"] = sum(p.numel() * 4 for p in params)
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pmesh.all_sum_grads(params)
        torch.cuda.synchronize()
        out["allreduce_s"] = time.perf_counter() - t0
        if rank == 0:  # the ranks are bitwise equal (check_replicas)
            want = torch.load(os.path.join(d, "train_params.pt"), mmap=True)
            moved = far = n = 0
            for name, v in named_trainable(trainable):
                diff = (v.detach().cpu() - want[name]).abs()
                moved = max(moved, float(diff.max()))
                far += int((diff > 0.5 * LR).sum())
                n += diff.numel()
            out.update(max_param_diff=moved, share_beyond_half_lr=far / n)
        del model, trainable, opt_state, step, init_fn, params
        gc.collect()
        torch.cuda.empty_cache()
    loss, grads, launched = forecast_micro_step(dev, batch, mesh)
    out["micro"] = {"mesh": arg, "loss": loss, "launches": launched}
    torch.save(grads, os.path.join(d, f"micro_{arg}_{rank}.pt"))
    with open(os.path.join(d, f"{part}{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def start_spatial_forecast(ref):
    """Phase 18's workers, started beside the record, vae_train and sc4dvar
    phases: 2 `--spatial-forecast-worker prod` ranks ((b), then (a) at
    1x1x2) and 4 `--spatial-forecast-worker micro` ranks ((a) at 2x1x2),
    all on the one card over gloo, with the train phase's inputs and
    parameters after step 2 and (a)'s batch in their directory."""
    import numpy as np
    import torch

    d = tempfile.mkdtemp(prefix="spatial_forecast")
    atexit.register(shutil.rmtree, d, True)
    shutil.move(ref["inputs"], os.path.join(d, "train_inputs.pt"))
    shutil.move(ref.pop("params"), os.path.join(d, "train_params.pt"))
    rng = np.random.default_rng(7)
    torch.save({k: torch.from_numpy(rng.standard_normal((2, 17, *FORECAST_MICRO["img_size"]),
                                                        dtype=np.float32))
                for k in ("inp", "tar")}, os.path.join(d, "micro_batch.pt"))
    return d, (start_workers("--spatial-forecast-worker", 2, [d, "prod"]),
               start_workers("--spatial-forecast-worker", 4, [d, "micro"]))


def check_spatial_forecast(started, ref):
    """Phase 18: the forecast trainer's spatial mesh (run_train_forecast
    --mesh DPxSHxSW: window-aligned tiles at the 90x180 level, the
    full-grid LG stage whole on every rank, each rank's share of the loss,
    the gradients summed over the ranks), its workers started by
    start_spatial_forecast. (a) the micro f32 step at 1x1x2 and 2x1x2
    against one process on the card: loss rel 1e-5, gradients 1e-3 x
    max|grad| (f32 sums in other orders), the ranks bitwise equal, the
    flash kernels launched by stage 0. (b) FORECAST_025 at 1x1x2, b1 bf16
    remat Possloss, 2 steps on 2 ranks against the train phase's first 2 on
    the same inputs and weights, with the spatial_train phase's bf16
    tolerances and reasons (check_spatial_train): losses within 2^-7 (step
    1) and 2^-6 (step 2) relative, each tensor's step-1 gradient norm within
    2^-6 of its own plus 2^-8 of the largest, the parameters after step 2
    within 4.01 lr; the ranks bitwise equal; (8, 4, 4) flash launches per
    rank and step (stage 0 runs whole on each rank). Prints each rank's
    peak memory beside the train phase's, its step seconds, the exchanges
    of each step (count and bytes by kind) and the gradient all-reduce
    alone. Returns (b)'s launches, summed over the ranks and steps."""
    import numpy as np
    import torch

    d, (prod, micro) = started
    try:
        wall = [wait_workers(w, 900) for w in (prod, micro)]
        ranks = {part: [json.load(open(os.path.join(d, f"{part}{r}.json"))) for r in range(n)]
                 for part, n in (("prod", 2), ("micro", 4))}
    finally:
        for w in (prod, micro):
            for p in w.procs:
                p.kill()
    batch = torch.load(os.path.join(d, "micro_batch.pt"))
    l1, g1, launched = forecast_micro_step("cuda", batch)
    scale = g1.abs().max().item()
    for arg, part, n in (("1x1x2", "prod", 2), ("2x1x2", "micro", 4)):
        got = [(r["micro"], torch.load(os.path.join(d, f"micro_{arg}_{r['rank']}.pt")))
               for r in ranks[part]]
        lerr = max(abs(m["loss"] - l1) / abs(l1) for m, _ in got)
        gerr = max((g - g1).abs().max().item() for _, g in got)
        same = all(m["loss"] == got[0][0]["loss"] and torch.equal(g, got[0][1]) for m, g in got)
        phase("spatial_forecast", f"(a) micro f32 Possloss step at --mesh {arg}, {n} ranks on "
              f"the card over gloo, vs one process on the card: loss {got[0][0]['loss']:.7g} vs "
              f"{l1:.7g} (rel {lerr:.3g}, tol 1e-5); gradients max|d| {gerr:.3g} <= "
              f"{1e-3 * scale:.3g} (1e-3 x max|grad|); ranks bitwise equal {same}; flash "
              f"launches per rank {[m['launches'] for m, _ in got]} (one process {launched})")
        if not (same and lerr <= 1e-5 and gerr <= 1e-3 * scale
                and all(m["launches"] == launched and min(launched) > 0 for m, _ in got)):
            raise AssertionError(f"the {arg} micro forecast step disagrees with one process")

    r0 = ranks["prod"][0]
    phase("spatial_forecast", f"(b) FORECAST_025 721x1440 b1 bf16 remat Possloss at --mesh "
          f"1x1x2: each rank's input tile {r0['tile']}; the 90x180 level's tiles: {r0['layout']}")
    for r in ranks["prod"]:
        phase("spatial_forecast", f"(b) rank {r['rank']} on {r['device']} (gloo): set-up "
              f"{r['setup_s']:.2f} s; losses " + ", ".join(f"{v:.7g}" for v in r["losses"])
              + "; step seconds " + ", ".join(f"{v:.3f}" for v in r["secs"])
              + f"; peak memory {r['peak_gib']:.2f} GiB against {ref['peak_gib']:.2f} GiB in "
              f"one process (the train phase); launches per step (fwd, dq, dkv) "
              f"{r['launches']}; the gradient all-reduce alone (gloo, "
              f"{r['grad_bytes'] / 1e9:.2f} GB of f32) {r['allreduce_s']:.3f} s; checksum "
              f"{r['checksum']!r}")
        for k, ex in enumerate(r["exchanges"]):
            phase("spatial_forecast", f"(b) rank {r['rank']} step {k + 1} exchanges (count, "
                  "bytes sent in all, smallest-largest, seconds from a synchronized start): "
                  + "; ".join(f"{name} {c}, {b / 1e6:.3f} MB, {lo}-{hi} B, {t:.3f} s"
                              for name, (c, b, lo, hi, t) in ex.items()))
    lerr = [abs(a - b) / abs(b) for a, b in zip(r0["losses"], ref["losses"])]
    n1, n2 = np.asarray(ref["norms"]), np.asarray(r0["norms"])
    nerr = np.abs(n2 - n1) - (SPATIAL_NORM_TOL[0] * n1 + SPATIAL_NORM_TOL[1] * n1.max())
    phase("spatial_forecast", "(b) vs the train phase's single process, steps 1-2: losses "
          + ", ".join(f"{a:.7g} vs {b:.7g}" for a, b in zip(r0["losses"], ref["losses"]))
          + "; rel " + ", ".join(f"{e:.3g}" for e in lerr) + " (tol 2^-7, 2^-6); step-1 "
          f"gradient norms: max rel {np.max(np.abs(n2 - n1) / np.maximum(n1, 1e-30)):.3g}, "
          f"worst margin {nerr.max():.3g} (<= 0: within 2^-6 of each + 2^-8 of the largest, "
          f"{n1.max():.4g}); parameters after step 2 max|d| {r0['max_param_diff']:.3g} <= "
          f"{ADAM_REACH * LR:.3g} ({ADAM_REACH} lr), {100 * r0['share_beyond_half_lr']:.3f} % "
          f"beyond lr/2; workers {wall[0]:.1f} s and {wall[1]:.1f} s with their start")
    bad = [r for r in ranks["prod"] if any(c != [8, 4, 4] for c in r["launches"])
           or r["losses"] != r0["losses"] or r["checksum"] != r0["checksum"]]
    if bad or not (lerr[0] <= SPATIAL_LOSS_TOL[0] and lerr[1] <= SPATIAL_LOSS_TOL[1]
                   and (nerr <= 0).all() and r0["max_param_diff"] <= ADAM_REACH * LR
                   and all(np.isfinite(r0["losses"]))):
        raise AssertionError("the 1x1x2 FORECAST_025 steps disagree with one process, or the "
                             "ranks differ")
    counts = np.sum([r["launches"] for r in ranks["prod"]], axis=(0, 1))
    return dict(zip(("flash_fwd", "flash_dq", "flash_dkv"), map(int, counts)))


# the micro cycles of the mesh phase's part (b): reduced 3D-Var and the da_win
# 3 reduced window, f32, one cycle after a 1-step spin-up (no flash stage)
MESH_MICRO = ["--micro", "--fast_init", "--grid", "32x64", "--solver_grid", "32x64",
              "--init_lag", "1", "--Nit", "2", "--no-bf16", "--use_eval",
              "--end_time", "2022-01-01 06:00:00"]
# name: (flags beside MESH_MICRO, mesh); the single-process run of each takes
# the flags alone
MESH_MICRO_RUNS = {"3dvar": ([], "2x2"), "window": (["--da_win", "3"], "2x2"),
                   "tp_3dvar": ([], "2x1x2"), "tp_window": (["--da_win", "3"], "2x1x2"),
                   "tp_3dvar_bf16": (["--bf16", "--save_field"], "2x1x2")}
# the full-width real-obs cycle of part (a): REAL_OBS_ARGS cut to its first cycle
MESH_REAL_OBS = REAL_OBS_ARGS + ["--end_time", "2022-01-01 06:00:00"]


def mesh_worker(d, argv):
    """One rank of the mesh phase, on the one card over gloo: run_da.main
    for each of the runs `argv` names (`--runs a,b` picks entries of
    MESH_MICRO_RUNS, each with its mesh; else argv is one run's flags), each
    with the launch counts set to 0 just before and read just after; writes
    <d>/<run>.<rank>.json."""
    import torch

    from vaevar_tpu_torch import run_da
    from vaevar_tpu_torch.parallel import mesh as pmesh

    rank = pmesh.init_distributed(backend="gloo", device="cuda")
    if argv[0] == "--runs":
        runs = {n: MESH_MICRO + MESH_MICRO_RUNS[n][0] + ["--mesh", MESH_MICRO_RUNS[n][1]]
                for n in argv[1].split(",")}
    else:
        runs = {"real_obs": argv}
    for name, flags in runs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mark = flash_launches()
        t0 = time.perf_counter()
        da = run_da.main(flags + ["--work_dir", os.path.join(d, name)])
        torch.cuda.synchronize()
        out = {"rank": rank, "seconds": time.perf_counter() - t0,
               "launches": list(flash_launches(mark)),
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "cycle_log": da.cycle_log, "timings": da.timings, "work_dir": da.work_dir,
               "digests": da.lockstep_digests, "backend": torch.distributed.get_backend(),
               "device": str(da.device)}
        with open(os.path.join(d, f"{name}.{rank}.json"), "w") as f:
            json.dump(out, f, default=str)
        del da
        gc.collect()
        torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()




def _rel(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def compare_cycles(name, got, want, out_got, out_want, tol=1e-3):
    """A sharded cycle against the single-process one: equal iterations and
    evals per segment, Jb and Jo per segment and the metric rows within
    `tol` relative (tests/test_torch_da_surface.py's); prints each."""
    errs = {"Jb": _rel(got["jb"], want["jb"]), "Jo": _rel(got["jo"], want["jo"])}
    errs.update({k: _rel(out_got[k], out_want[k]) for k in out_want})
    phase("mesh", f"{name}: iterations {got['n_iters']} (single {want['n_iters']}), evals "
          f"{got['n_evals']} ({want['n_evals']}); Jb {got['jb']} ({want['jb']}); Jo {got['jo']} "
          f"({want['jo']}); largest relative differences "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f" (tol {tol:g})")
    if got["n_iters"] != want["n_iters"] or got["n_evals"] != want["n_evals"] or \
            max(errs.values()) > tol:
        raise AssertionError(f"{name}: the sharded cycle disagrees with the single-process one")


def check_mesh(ref):
    """Phase 16: the spatially partitioned solve (run_da --mesh SHxSW,
    parallel/mesh.py). (a) REAL_OBS_ARGS' first cycle as --mesh 1x2 on 2
    ranks over gloo on the one card (nccl refuses two ranks on one device),
    held to the real_obs phase's cycle 1 (`ref`); (b) micro --mesh 2x2 and
    2x1x2 (4 ranks) reduced 3D-Var and da_win 3 window cycles against
    single-process runs here, and a bf16 2x1x2 3D-Var cycle; (c) run_da
    --mesh 1x1x1 through torch.distributed.run with nccl, beside (b); (d),
    (e) in 2 tensor-parallel workers (`tp_worker`), beside (a). Returns the
    flash launches of (a) and (e), summed over the ranks."""
    import numpy as np
    import torch

    from vaevar_tpu_torch import config as cfgs

    per_step = cfgs.FORECAST_025.lg_depths[0]
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as tp_dir:
        tp_workers = start_workers("--tp-worker", 2, [tp_dir])
        try:
            wall = launch_workers("--mesh-worker", 2, [d, *MESH_REAL_OBS, "--mesh", "1x2"],
                                  900)
            tp_wall = wait_workers(tp_workers, 600)
        finally:
            for p in tp_workers.procs:
                p.kill()
        ranks = [json.load(open(os.path.join(d, f"real_obs.{r}.json"))) for r in range(2)]
        work = ranks[0]["work_dir"]
        outs = {k: np.load(os.path.join(work, f"{k}.npy"))[0]
                for k in ("ana_wrmse", "bg_wrmse", "error_obs")}
        tp_ranks = [json.load(open(os.path.join(tp_dir, f"tp.{r}.json"))) for r in range(2)]
    want_launches = (8 + 1) * per_step
    for r in ranks:
        c = r["cycle_log"][0]
        phase("mesh", f"(a) rank {r['rank']} on {r['device']} ({r['backend']}): --mesh 1x2 "
              f"real_simu --use_eval, 1 cycle in {r['seconds']:.2f} s (models "
              f"{r['timings']['models_s']:.2f} s, spin-up {r['timings']['spin_up_s']:.2f} s, cycle "
              f"{c['seconds']:.2f} s: obs {c['obs_s']:.2f} s, solve {c['solve_s']:.2f} s); peak "
              f"memory {r['peak_gib']:.2f} GiB (one process, 2 cycles: {ref['peak_serial']:.2f} "
              f"GiB with --no_prefetch, {ref['peak']:.2f} GiB with the prefetch); yo + H "
              f"{c['obs_bytes'] / 1e9:.4f} GB on this rank (single process "
              f"{ref['cycle']['obs_bytes'] / 1e9:.4f} GB); obs gridded {c['n_gridded']:.0f}, kept "
              f"{c['n_kept']:.0f} ({ref['cycle']['n_gridded']:.0f}, {ref['cycle']['n_kept']:.0f}); "
              f"flash launches (fwd, dq, dkv) {r['launches']}; lockstep digests "
              + ", ".join(x[:12] for x in r["digests"]))
    phase("mesh", f"(a) {wall:.1f} s with the workers' start")
    r0, r1 = ranks
    compare_cycles("(a) rank 0's cycle 1 against the real_obs phase's", r0["cycle_log"][0],
                   ref["cycle"], outs, {k: ref[k] for k in outs})
    if r0["digests"] != r1["digests"] or len(r0["digests"]) != 2:
        raise AssertionError(f"(a) lockstep digests differ: {r0['digests']} {r1['digests']}")
    for r in ranks:
        c = r["cycle_log"][0]
        if tuple(r["launches"]) != (want_launches, 0, 0):
            raise AssertionError(f"(a) rank {r['rank']} launched {r['launches']}; want "
                                 f"({want_launches}, 0, 0)")
        if 2 * c["obs_bytes"] != ref["cycle"]["obs_bytes"]:
            raise AssertionError(f"(a) rank {r['rank']} holds {c['obs_bytes']} bytes of yo + H; "
                                 f"want half of {ref['cycle']['obs_bytes']}")
        if (c["n_gridded"], c["n_kept"]) != (ref["cycle"]["n_gridded"], ref["cycle"]["n_kept"]):
            raise AssertionError("(a) the ranks' obs counts do not add up to the single run's")
    counts = {"flash_fwd": sum(r["launches"][0] for r in ranks), "flash_dq": 0, "flash_dkv": 0}
    for k, v in check_tp(tp_ranks, tp_wall).items():
        counts[k] += v
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the CLI through torch.distributed.run, nccl, world size 1: one micro
    # process on the card and the host beside (b), which it does not touch
    with tempfile.TemporaryDirectory() as out, tempfile.TemporaryFile("w+") as log:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
               "--nproc_per_node", "1", "--master_addr", "localhost", "--master_port",
               str(_free_port()), "-m", "vaevar_tpu_torch.run_da", "--mesh", "1x1x1",
               *MESH_MICRO, "--work_dir", out]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, text=True,
                                cwd=os.path.dirname(os.path.abspath(__file__)),
                                start_new_session=True)
        try:
            check_mesh_micro()
            proc.wait(timeout=300)
        finally:
            if proc.poll() is None:  # torchrun and its worker, on a failure here
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        seconds = time.perf_counter() - t0
        files = {f for _, _, fs in os.walk(out) for f in fs}
        log.seek(0)
        text = log.read()
    nccl = "mesh: tp 1 x sh 1 x sw 1, rank 0 on cuda:0 (nccl)" in text
    phase("mesh", f"(c) torch.distributed.run --nproc_per_node 1 run_da --mesh 1x1x1: exit "
          f"{proc.returncode} in {seconds:.1f} s, beside (b); nccl process group {nccl}; "
          f"files {sorted(files)}")
    if proc.returncode != 0 or not nccl or "xb.npy" not in files:
        raise AssertionError(f"the nccl run_da run failed:\n{text[-6000:]}")
    return counts


def _increment(work):
    import numpy as np

    (xa,) = [f for f in os.listdir(work) if f.startswith("xa_")]
    return np.load(os.path.join(work, xa)) - np.load(os.path.join(work, "xb_" + xa[3:]))


def check_mesh_micro():
    """The mesh phase's part (b): micro --mesh 2x2 and --mesh 2x1x2 (4
    ranks) reduced 3D-Var and da_win 3 window cycles against single-process
    runs here, and a bf16 --mesh 2x1x2 3D-Var cycle's increment against one
    process's."""
    import numpy as np

    from vaevar_tpu_torch import run_da

    with tempfile.TemporaryDirectory() as d:
        wall = launch_workers("--mesh-worker", 4, [d, "--runs", ",".join(MESH_MICRO_RUNS)], 600)
        singles = {}
        for name, (extra, mesh) in MESH_MICRO_RUNS.items():
            ranks = [json.load(open(os.path.join(d, f"{name}.{r}.json"))) for r in range(4)]
            if tuple(extra) not in singles:
                singles[tuple(extra)] = run_da.main(
                    MESH_MICRO + extra + ["--work_dir", os.path.join(d, f"single_{name}")])
            single = singles[tuple(extra)]
            if len({tuple(r["digests"]) for r in ranks}) != 1:
                raise AssertionError(f"(b) {name}: the ranks' lockstep digests differ")
            what = f"(b) micro {name} --mesh {mesh}, rank 0 against one process"
            if "--bf16" in extra:
                inc, ref = _increment(ranks[0]["work_dir"]), _increment(single.work_dir)
                rel = float(np.linalg.norm(inc - ref) / np.linalg.norm(ref))
                c, c1 = ranks[0]["cycle_log"][0], single.cycle_log[0]
                phase("mesh", f"{what}: analysis increment norm-rel {rel:.3g} (tol 1e-3); "
                      f"iterations {c['n_iters']} ({c1['n_iters']}), evals {c['n_evals']} "
                      f"({c1['n_evals']}); param bytes {c['param_bytes']} ({c1['param_bytes']})")
                if not rel <= 1e-3:
                    raise AssertionError(f"{what}: the increment disagrees")
                continue
            rows = [{k: np.load(os.path.join(w, f"{k}.npy"))[0]
                     for k in ("ana_wrmse", "error_obs")}
                    for w in (ranks[0]["work_dir"], single.work_dir)]
            compare_cycles(what, ranks[0]["cycle_log"][0], single.cycle_log[0], *rows)
        del singles
    phase("mesh", f"(b) 4 ranks, {wall:.1f} s with the workers' start")


# the mesh phase's part (e): a MoEMlp at the LG stage's widths, 8 experts
TP_MOE = dict(dim=192, hidden=768, num_experts=8)


def tp_worker(d):
    """One rank of the mesh phase's parts (d) and (e): 2 ranks on the one
    card over gloo, tp 2 (`--mesh 2x1x1`), ep 2. Writes tp.<rank>.json under
    `d`."""
    import copy

    import numpy as np
    import torch

    from vaevar_tpu_torch import config as cfgs
    from vaevar_tpu_torch.models import zoo
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.parallel import mesh as pmesh
    from vaevar_tpu_torch.train import forecast_trainer as ft

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import test_torch_prod_pinned as pinned

    rank = pmesh.init_distributed(backend="gloo", device="cuda")
    mesh = pmesh.spatial_mesh_from_arg("2x1x1", "cuda")
    out = {"rank": rank}

    def nbytes(m):
        return sum(p.numel() * p.element_size() for p in m.parameters())

    # (d) the production decoder at tp 2, JAX's pinned golden
    t0 = time.perf_counter()
    decoder = filled(lambda: LGUnet(cfgs.VAE_DECODER), 0).to(mesh.device)
    out["whole_bytes"] = nbytes(decoder)
    pmesh.shard_tensor_parallel(decoder, mesh)
    torch.cuda.synchronize()
    out.update(build_s=time.perf_counter() - t0, param_bytes=nbytes(decoder),
               report=pmesh.tensor_parallel_report(decoder))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out["summary"] = pinned.compute_summary("cuda", decoder)
    torch.cuda.synchronize()
    out.update(summary_s=time.perf_counter() - t0,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del decoder
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the micro flash model placed at tp 2: forward and one train step
    # against the unplaced model, the placed run's launches counted
    rng = np.random.default_rng(4)
    x, tar = (torch.from_numpy(rng.standard_normal((1, 69, 32, 64), dtype=np.float32)).cuda()
              for _ in range(2))

    def run(place):
        model = micro_model().cuda().eval()
        if place:
            pmesh.shard_tensor_parallel(model, mesh)
        with torch.no_grad():
            y = model(x)
        model = micro_model(remat=True).cuda().train()
        if place:
            pmesh.shard_tensor_parallel(model, mesh)
        init_fn, step = ft.make_forecast_train_step(model, "Possloss", lr=1e-4, total_steps=10,
                                                    out_shape=(138, 32, 64))
        trainable, opt_state = init_fn()
        _, _, loss = step(trainable, opt_state, x, [tar])
        for p in model.parameters():
            p.data = p.grad
        grads = pmesh.tensor_parallel_state_dict(model) if place else model.state_dict()
        return y, loss.item(), torch.cat([grads[k].flatten() for k in sorted(grads)])

    y_ref, loss_ref, g_ref = run(False)
    mark = flash_launches()
    y, loss, g = run(True)
    torch.cuda.synchronize()
    out["launches"] = list(flash_launches(mark))
    out["micro"] = {"y_err": (y - y_ref).abs().max().item(), "loss": loss, "loss_ref": loss_ref,
                    "g_err": (g - g_ref).abs().max().item(), "g_scale": g_ref.abs().max().item(),
                    "finite": bool(torch.isfinite(y).all() and torch.isfinite(g).all())}
    out["micro_report"] = pmesh.tensor_parallel_report(
        pmesh.shard_tensor_parallel(micro_model(), mesh))

    # (e) the experts at ep 2 against the unplaced bank, the same router draw
    torch.manual_seed(0)
    ref = zoo.MoEMlp(**TP_MOE).cuda()
    bank = pmesh.shard_experts(copy.deepcopy(ref), pmesh.expert_mesh(2))
    xm = torch.from_numpy(rng.standard_normal((1, 90, 180, TP_MOE["dim"]),
                                              dtype=np.float32)).cuda()
    res = {}
    for name, m in (("ref", ref), ("ep", bank)):
        xg = xm.clone().requires_grad_(True)
        ym, zm, bm = m(xg, rng=torch.Generator(device="cuda").manual_seed(7))
        (torch.mean(ym ** 2) + zm + bm).backward()
        res[name] = (ym.detach(), zm.item(), bm.item(), xg.grad,
                     {k: p.grad for k, p in m.named_parameters()})
    (y0, z0, b0, gx0, gp0), (y1, z1, b1, gx1, gp1) = res["ref"], res["ep"]
    n = TP_MOE["num_experts"] // 2
    block = slice(rank * n, (rank + 1) * n)
    g_errs = {"input": ((gx1 - gx0).abs().max() / gx0.abs().max()).item()}
    for k, v in gp1.items():
        want = gp0[k][block] if k.split(".")[-1] in ("w1", "b1", "w2", "b2") else gp0[k]
        g_errs[k] = ((v - want).abs().max() / want.abs().max()).item()
    out["moe"] = {"y_excess": ((y1 - y0).abs() - 1e-6 - 2e-6 * y0.abs()).max().item(),
                  "y_err": (y1 - y0).abs().max().item(), "z": [z1, z0], "b": [b1, b0],
                  "g_rel": g_errs, "experts": [block.start, block.stop]}
    with open(os.path.join(d, f"tp.{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def check_tp(ranks, wall):
    """The mesh phase's parts (d) and (e) from the tp workers' records:
    prints and checks them; returns (e)'s launches, summed over the ranks."""
    import numpy as np

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    sys.path.insert(0, tests)
    import test_torch_prod_pinned as pinned

    with open(pinned.ART) as f:
        golden = json.load(f)
    for r in ranks:
        rel = pinned.relative_errors(r["summary"], golden)
        phase("mesh", f"(d) rank {r['rank']}: VAE_DECODER f32 at tp 2, built and placed in "
              f"{r['build_s']:.2f} s, {r['param_bytes'] / 1e9:.4f} GB of parameters on this "
              f"rank against {r['whole_bytes'] / 1e9:.4f} GB whole; pinned summary in "
              f"{r['summary_s']:.2f} s, peak {r['peak_gib']:.2f} GiB; relative errors against "
              f"tests/goldens/prod_geometry_pinned.json (tol {pinned.RTOL_SCALAR:g} on the "
              f"scalars, {pinned.RTOL_PROBE:g} on inc_probe): "
              + ", ".join(f"{k} {v:.3g}" for k, v in rel.items()))
        if pinned.misses(rel):
            raise AssertionError(f"(d) rank {r['rank']}: the tp 2 summary misses JAX's pinned "
                                 f"golden: {pinned.misses(rel)}")
    phase("mesh", "(d) placement: " + "; ".join(ranks[0]["report"]))
    if ranks[0]["summary"] != ranks[1]["summary"]:
        raise AssertionError("(d) the tp ranks' summaries differ")
    for r in ranks:
        m, e = r["micro"], r["moe"]
        phase("mesh", f"(e) rank {r['rank']}: micro rope flash LGUnet at tp 2 against the "
              f"unplaced model on the card: forward max|d| {m['y_err']:.3g} (atol 1e-4), train "
              f"step loss {m['loss']:.7g} vs {m['loss_ref']:.7g}, gradients max|d| "
              f"{m['g_err']:.3g} <= {1e-3 * m['g_scale']:.3g} (1e-3 x max|grad|); placed flash "
              f"launches (fwd, dq, dkv) {r['launches']}; placement: "
              + "; ".join(r["micro_report"]))
        phase("mesh", f"(e) rank {r['rank']}: MoEMlp {TP_MOE} at 90x180 on experts "
              f"{e['experts']} at ep 2: output max|d| {e['y_err']:.3g} (rtol 2e-6 + atol "
              f"1e-6), z {e['z'][0]!r} vs {e['z'][1]!r}, balance {e['b'][0]!r} vs {e['b'][1]!r} "
              f"(rtol 1e-6); gradients relative to their largest entry: max "
              f"{max(e['g_rel'].values()):.3g} (tol 5e-5)")
        if not (m["finite"] and m["y_err"] <= 1e-4 and abs(m["loss"] - m["loss_ref"]) <= 1e-4
                and m["g_err"] <= 1e-3 * m["g_scale"] and min(r["launches"]) > 0):
            raise AssertionError(f"(e) rank {r['rank']}: the tp micro model disagrees or "
                                 f"launched {r['launches']}")
        if not (e["y_excess"] <= 0 and max(e["g_rel"].values()) <= 5e-5 and all(
                abs(a - b) <= 1e-6 * abs(b) for a, b in (e["z"], e["b"]))):
            raise AssertionError(f"(e) rank {r['rank']}: the experts at ep 2 disagree: {e}")
    phase("mesh", f"(d), (e) 2 ranks, {wall:.1f} s with the workers' start, beside (a)")
    counts = np.sum([r["launches"] for r in ranks], axis=0)
    return dict(zip(("flash_fwd", "flash_dq", "flash_dkv"), map(int, counts)))


def top_device_ops(trace, n=5):
    """The n device operations (kernels, copies, fills) with the most time
    in a torch.profiler Chrome trace: [(name, ms, launches)], and
    the device time of all of them in ms. Read from the file: asking
    torch.profiler for its events builds a Python object per event, which
    took longer than the traced solve itself at this size."""
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    sums = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            ms, c = sums.get(e["name"], (0.0, 0))
            sums[e["name"]] = (ms + e.get("dur", 0) / 1e3, c + 1)
    rows = sorted(sums.items(), key=lambda kv: -kv[1][0])
    return [(k, ms, c) for k, (ms, c) in rows[:n]], sum(ms for ms, _ in sums.values())


def check_pinned():
    """The pinned phase: JAX's production-geometry golden on the card. The
    three models of the README cycle's roles and its window's flow model
    (VAE_DECODER from seed 0, FLOW_140 from 1, FORECAST_025 from 2), built
    by run_da.build_models with --fast_init as the CLI builds them, must
    carry the weights of tests/goldens/torch_fast_init_sha256.json (JAX's
    draw, digest by digest); then tests/test_torch_prod_pinned.py's
    construction runs on the card with that decoder in f32, under
    torch.profiler, and its summary must match
    tests/goldens/prod_geometry_pinned.json within JAX's tolerances."""
    import torch

    from vaevar_tpu_torch import config as cfgs
    from vaevar_tpu_torch import run_da
    from vaevar_tpu_torch.utils.fast_init import param_digests

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    sys.path.insert(0, tests)
    import test_torch_prod_pinned as pinned

    with open(os.path.join(tests, "goldens", "torch_fast_init_sha256.json")) as f:
        digests = json.load(f)
    shw = (128, 256)
    roles = {"VAE_DECODER": run_da.fit_grid(cfgs.VAE_DECODER, shw),
             "FLOW_140": run_da.fit_grid(cfgs.FLOW_140, shw),
             "FORECAST_025": cfgs.FORECAST_025}
    t0 = time.perf_counter()
    models = run_da.build_models(
        {role: (cfg, digests[role]["seed"], None, False) for role, cfg in roles.items()},
        "cuda", fast=True)
    torch.cuda.synchronize()
    phase("pinned", f"{', '.join(roles)} built together by run_da.build_models --fast_init "
          f"in {time.perf_counter() - t0:.2f} s")
    for role, model in models.items():
        seed, want = digests[role]["seed"], digests[role]["sha256"]
        t0 = time.perf_counter()
        got = param_digests(dict(model.named_parameters()))
        bad = sorted(k for k in set(want) | set(got) if got.get(k) != want.get(k))
        n = sum(p.numel() for p in model.parameters())
        phase("pinned", f"{role} (seed {seed}, {n / 1e6:.1f} M parameters): {len(want) - len(bad)} "
              f"of {len(want)} tensor digests equal JAX's draw ({time.perf_counter() - t0:.2f} s "
              "to hash them)")
        if bad:
            raise AssertionError(f"{role}: {len(bad)} tensors differ from JAX's draw, "
                                 f"e.g. {bad[:3]}")
    decoder = models.pop("VAE_DECODER")
    del models, model
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tdir:
        t0 = time.perf_counter()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            got = pinned.compute_summary("cuda", decoder)
            torch.cuda.synchronize()
            solve_s = time.perf_counter() - t0
        trace = os.path.join(tdir, "trace.json")
        prof.export_chrome_trace(trace)
        total_s = time.perf_counter() - t0
        size = os.path.getsize(trace)
        t0 = time.perf_counter()
        top, device_ms = top_device_ops(trace)
        top_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    phase("pinned", f"one_step_da, VAE_DECODER f32 at 128x256, free_0010, nit 1 x 2 L-BFGS "
          f"iterations, under torch.profiler: {solve_s:.2f} s with the summary, "
          f"{total_s - solve_s:.2f} s to write the trace; peak {peak / 2**30:.2f} GiB")
    phase("pinned", f"torch.profiler: Chrome trace {size / 1e6:.1f} MB; device time "
          f"{device_ms:.1f} ms ({top_s:.2f} s to sum it); top device operations: "
          + ("; ".join(f"{k[:70]} {ms:.1f} ms x{c}" for k, ms, c in top)
             or "none recorded (the profiler saw no device activity)"))
    with open(pinned.ART) as f:
        golden = json.load(f)
    rel = pinned.relative_errors(got, golden)
    phase("pinned", "relative errors against tests/goldens/prod_geometry_pinned.json (tol "
          f"{pinned.RTOL_SCALAR:g} on the scalars, {pinned.RTOL_PROBE:g} on inc_probe): "
          + ", ".join(f"{k} {v:.3g}" for k, v in rel.items()))
    phase("pinned", ", ".join(f"{k} {got[k]:.10g} (golden {golden[k]:.10g})"
                              for k in pinned.SCALARS))
    if pinned.misses(rel):
        raise AssertionError(f"the card's summary misses JAX's pinned golden: "
                             f"{pinned.misses(rel)}")
    del decoder
    gc.collect()
    torch.cuda.empty_cache()


def main():
    import torch

    from vaevar_tpu_torch.utils import trace

    trace.enable()
    t0 = time.perf_counter()
    out = run_phases()
    total_s = time.perf_counter() - t0
    seconds = phase_seconds(trace.records())
    phase("timer", "seconds per phase by the smoke's own clock (utils/trace.py spans):")
    for name in sorted(seconds):
        total, n = seconds[name]
        print(f"{name}: total {total:.2f}s x{n} (avg {total / n:.3f}s)", flush=True)
    phase("total", f"the smoke took {total_s:.1f} s")
    print(json.dumps({"kernels": out["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": out["kind"], "count": torch.cuda.device_count()}}),
        flush=True)


def phase_seconds(records) -> dict:
    """{name: (seconds, count)} of the main thread's outermost spans: the
    smoke's phases."""
    out = {}
    for r in records:
        if r["parent"] is None and r["thread"] == "MainThread":
            secs, n = out.get(r["name"], (0.0, 0))
            out[r["name"]] = (secs + (r["end_ns"] - r["start_ns"]) * 1e-9, n + 1)
    return out


def run_phases():
    """Every phase in order, each a span of its name; returns the kernels
    record and the card's name."""
    from vaevar_tpu_torch.utils import trace

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

    from vaevar_tpu_torch.ops import _build
    from vaevar_tpu_torch.ops import flash_attn as fa

    t0 = time.perf_counter()
    with trace.span("build"):
        built = _build.build_all(["flash_fwd", "flash_bwd"])
    phase("build", ", ".join(f"{p.name} in {s:.2f} s" + (" (reused)" if s == 0 else "")
                             for p, s in built.values())
          + f"; {time.perf_counter() - t0:.2f} s in all")

    with trace.span("kernel"):
        fwd = check_kernel(fa)
    with trace.span("bwd"):
        bwd = check_bwd(fa)
    with trace.span("model"):
        check_model()
    with trace.span("pinned"):
        check_pinned()

    with trace.span("main"):
        launches = check_main()
    with trace.span("window"):
        window_launches = check_window()[0]
        check_micro_window()
    gc.collect()
    torch.cuda.empty_cache()

    with trace.span("train"):
        train_counts, step_s, train_ref = check_forecast_training()
    gc.collect()
    torch.cuda.empty_cache()
    with trace.span("cli"):
        check_cli()
    gc.collect()
    torch.cuda.empty_cache()
    # the OSSE (micro, deterministic) in a process of its own beside the
    # record and vae_train phases; its output is replayed where it joins
    osse_worker = start_workers("--osse-worker", 1, [])
    # the spatial_forecast phase's ranks beside record, vae_train and sc4dvar
    forecast_mesh = start_spatial_forecast(train_ref)
    with trace.span("record"):
        record_launches = check_record()
    gc.collect()
    torch.cuda.empty_cache()
    with trace.span("vae_train"):
        vae_launches, vae_ref = check_vae_train()
    gc.collect()
    torch.cuda.empty_cache()
    with trace.span("sc4dvar"):
        sc4dvar_launches = check_sc4dvar()
    gc.collect()
    torch.cuda.empty_cache()
    with trace.span("spatial_forecast"):
        sf_counts = check_spatial_forecast(forecast_mesh, train_ref)
    gc.collect()
    torch.cuda.empty_cache()
    # the spatial_train phase's ranks run beside real_obs, whose time is
    # mostly the host's
    spatial = start_spatial_train(vae_ref)
    with trace.span("real_obs"):
        real_obs_launches, real_obs_ref = check_real_obs()
    gc.collect()
    torch.cuda.empty_cache()
    with trace.span("osse"):
        try:
            osse_s = wait_workers(osse_worker, 900)
        finally:
            for p in osse_worker.procs:
                p.kill()
        print(osse_worker.texts[0], end="", flush=True)
        phase("osse", f"its process joined here {osse_s:.1f} s after it started with the record "
              "phase")
    with trace.span("spatial_train"):
        check_spatial_train(spatial, vae_ref)
    gc.collect()
    torch.cuda.empty_cache()
    with trace.span("sd_zoo"):
        sd_counts = check_sd_zoo()
    gc.collect()
    torch.cuda.empty_cache()
    with trace.span("dp"):
        dp_counts = check_dp(step_s)
    gc.collect()
    torch.cuda.empty_cache()
    with trace.span("mesh"):
        mesh_counts = check_mesh(real_obs_ref)

    stats = {"flash_fwd": fwd, "flash_dq": bwd["flash_dq"], "flash_dkv": bwd["flash_dkv"]}
    replaces = {"flash_fwd": ("flash_fwd.cu", "vaevar_tpu/ops/pallas_attn.py:47"),
                "flash_dq": ("flash_bwd.cu", "vaevar_tpu/ops/pallas_attn.py:127"),
                "flash_dkv": ("flash_bwd.cu", "vaevar_tpu/ops/pallas_attn.py:162")}
    kernels = []
    for name, (src, tpu) in replaces.items():
        main, rec = stats[name]["main"], {
            "name": name, "route": "cuda", "source": f"vaevar_tpu_torch/csrc/{src}",
            "replaces": tpu,
            "launches": train_counts[name] + dp_counts[name] + sd_counts[name]
            + mesh_counts[name] + sf_counts[name] + (
                launches + window_launches + record_launches + vae_launches + sc4dvar_launches
                + real_obs_launches if name == "flash_fwd" else 0),
            "max_abs_err": stats[name]["max_abs_err"]}
        rec.update(main)
        rec["share_of_bound"] = main["bound_ms"] / main["ms"]
        rec["bf16"] = stats[name]["bf16"]
        if name != "flash_fwd":  # dq + dkv + D together against the library's backward
            rec["pair"] = bwd["pair"]
        if "build" in stats[name]:
            rec["build"] = stats[name]["build"]
        kernels.append(rec)
    return {"kernels": kernels, "kind": kind}


def check_main():
    """The main phase: the README cycle through run_da; returns its forward
    launches."""
    import torch

    from vaevar_tpu_torch import config as cfgs
    from vaevar_tpu_torch import run_da

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as work:
        mark = flash_launches()
        graph_mark = solve_graph_counts()
        t0 = time.perf_counter()
        da = run_da.main(MAIN_ARGS + ["--work_dir", work])
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        da_counts = flash_launches(mark)
        graphs = solve_graph_counts(graph_mark)
        launches = da_counts[0]
        files = sorted(os.listdir(da.work_dir))
    peak = torch.cuda.max_memory_allocated()

    n_cycles = len(da.cycle_log)
    want = (da.cfg.init_lag + n_cycles) * cfgs.FORECAST_025.lg_depths[0]
    phase("main", f"{n_cycles} cycles in {total:.2f} s; spin-up "
          f"{da.timings['spin_up_s']:.2f} s; cycles "
          + ", ".join(f"{s:.2f}" for s in da.timings["cycle_s"])
          + f" s; peak memory {peak / 2**30:.2f} GiB; flash launches (fwd, dq, dkv) "
          f"{da_counts}")
    last = da.cycle_log[-1]
    phase("main", f"obs prefetch {da.prefetch_obs}: cycle {n_cycles} obs {last['obs_s']:.3f} s "
          f"on the worker, the loop waited {last['obs_wait_s']:.3f} s")
    if n_cycles != 2 or da_counts != (want, 0, 0) or not da.prefetch_obs:
        raise AssertionError(f"{n_cycles} cycles, flash launches {da_counts}; "
                             f"want 2, ({want}, 0, 0)")
    captures, replays, probes, jvp = graphs
    phase("main", f"solve graphs: {captures} capture, {replays} replays of {probes} probes "
          f"({jvp} jvp probes, eager)")
    if captures != 1 or replays != probes - jvp or not replays:
        raise AssertionError(f"the README solve ran {replays} of {probes - jvp} value+grad "
                             f"probes as graph replays after {captures} captures; want all "
                             "after 1")
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
    del da
    gc.collect()
    torch.cuda.empty_cache()
    return launches


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--osse-worker"]:
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        sys.exit(check_osse())
    if sys.argv[1:2] == ["--tp-worker"]:
        sys.exit(tp_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--spatial-worker"]:
        sys.exit(spatial_worker(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--spatial-forecast-worker"]:
        sys.exit(spatial_forecast_worker(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
