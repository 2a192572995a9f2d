"""The cycler's obs prefetch thread (vaevar_tpu_torch/da/cycler.py,
`prefetch_obs`, run_da's --no_prefetch) changes no number.

Each case runs `run_da.main` on the CPU at micro size for 3 cycles twice,
with the prefetch worker (the default) and with --no_prefetch, and holds the
two runs bitwise equal: xb.npy, current_time.txt, every .npy dump (metrics
and the per-cycle xb/xa, truth and obs fields) and the cycle log apart from
its timings. The cases are the three kinds of obs preparation: synthetic
column_random masks (drawn from one generator in cycle order), real_simu
with --use_eval on a synthetic station network (gridding, augmentation and
QC on the worker), and a reference-layout store read through the native
pool with --forecast_eval, whose truth reads the loop orders before the
next prefetch. A truth frame missing at cycle 2 raises from
run_assimilation in both modes, after cycle 1 is saved alike. On a CUDA
device the worker runs on its own stream (chip_smoke.py's real_obs phase
compares the two modes there)."""

from datetime import datetime, timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

from vaevar_tpu_torch import run_da
from vaevar_tpu_torch.data import era5 as tera5

torch.set_num_threads(1)
T0 = datetime(2022, 1, 1)
END = "2022-01-01 18:00:00"  # three 6 h cycles
TIMINGS = {"seconds", "obs_s", "obs_wait_s", "truth_s", "grid_s", "aug_qc_s", "reduce_s",
           "solve_s"}


def _run(work, *extra):
    return run_da.main(["--device", "cpu", "--micro", "--fast_init", "--grid", "32x64",
                        "--solver_grid", "16x32", "--init_lag", "1", "--Nit", "1",
                        "--end_time", END, "--save_field", "--save_gt", "--save_obs",
                        "--work_dir", str(work), *extra])


def _write_store(root, times, layout="reference"):
    src = tera5.SyntheticEra5(hw=(32, 64), seed=0)
    store = (tera5.ReferenceLayoutStore(root, (32, 64), use_native=False)
             if layout == "reference" else tera5.LocalNpyStore(root, (32, 64)))
    for ts in times:
        store.save_state(ts, src.get_state(ts))


def _outputs(da):
    run = Path(da.work_dir)
    files = {f.name: np.load(f, allow_pickle=True) for f in sorted(run.glob("*.npy"))}
    files["current_time.txt"] = (run / "current_time.txt").read_text()
    return files


def _assert_same_runs(on, off):
    assert on.prefetch_obs and not off.prefetch_obs
    got, want = _outputs(on), _outputs(off)
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        if isinstance(arr, np.ndarray) and arr.dtype == object:
            assert len(got[name]) == len(arr), name
            for a, b in zip(got[name], arr):
                np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], arr, err_msg=name)
    strip = [{k: v for k, v in c.items() if k not in TIMINGS} for c in off.cycle_log]
    assert [{k: v for k, v in c.items() if k not in TIMINGS} for c in on.cycle_log] == strip
    for c in on.cycle_log + off.cycle_log:
        assert c["obs_s"] >= 0 and c["obs_wait_s"] >= 0
    return got


@pytest.mark.parametrize("kind", ["column_random", "real_simu", "reference_forecast_eval"])
def test_prefetch_changes_no_number(kind, tmp_path):
    extra = []
    if kind == "real_simu":
        extra = ["--obs_type", "real_simu", "--use_eval", "--n_stations", "300"]
    elif kind == "reference_forecast_eval":
        data = str(tmp_path / "era5")
        _write_store(data, [T0 + timedelta(hours=6 * i) for i in range(-1, 6)])
        extra = ["--data_dir", data, "--data_layout", "reference", "--forecast_eval",
                 "--forecast_eval_steps", "2"]
    on = _run(tmp_path / "on", *extra)
    off = _run(tmp_path / "off", *extra, "--no_prefetch")
    assert len(on.cycle_log) == 3
    got = _assert_same_runs(on, off)
    assert len([n for n in got if n.startswith("obs_")]) == 3
    # the obs each cycle received differ from cycle to cycle
    assert len({tuple(c["obs_checksum"]) for c in on.cycle_log}) == 3
    if kind == "real_simu":
        assert got["error_obs.npy"].shape == (3, 204)
        assert on.last_obs_info == off.last_obs_info | {
            k: on.last_obs_info[k] for k in ("truth_s", "grid_s", "aug_qc_s")}
        assert all(0 < c["n_kept"] <= c["n_gridded"] for c in on.cycle_log)
    if kind == "reference_forecast_eval":
        assert on.state_source.reader == "native"
        assert got["forecast_wrmse.npy"].shape == (3, 2, 69)


def test_missing_truth_raises_in_both_modes(tmp_path):
    data = str(tmp_path / "era5")
    # the spin-up frame and cycle 1's truth, not cycle 2's
    _write_store(data, [T0 - timedelta(hours=6), T0], layout="state")
    saved = {}
    for mode, extra in (("on", []), ("off", ["--no_prefetch"])):
        with pytest.raises(FileNotFoundError, match="2022-01-01_06"):
            _run(tmp_path / mode, "--data_dir", data, *extra)
        (run,) = (tmp_path / mode).glob("run_*")
        saved[mode] = ((run / "current_time.txt").read_text(), np.load(run / "xb.npy"))
    assert saved["on"][0] == saved["off"][0] == "2022-01-01 06:00:00"
    np.testing.assert_array_equal(saved["on"][1], saved["off"][1])


def test_no_prefetch_flag():
    assert not run_da.arg_parser([]).no_prefetch
    assert run_da.arg_parser(["--no_prefetch"]).no_prefetch
