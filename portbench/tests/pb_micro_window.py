"""Micro-size copy of the 4D-Var window configuration for the benchmark's
CPU tests (the CPU stands in for the card, in float32)."""

from __future__ import annotations

import time

import pb_micro
import harness

CELL = "vaevar_4dvar_025.synth_win6"


def micro_window_config():
    """vaevar_4dvar_025 at 64x128 with a 32x64 solver grid: the micro
    decoder and forecast model of pb_micro.micro_da_config, and a micro
    relbias flow model beside the decoder."""
    cfg = harness.config_file("vaevar_4dvar_025")
    da = pb_micro.micro_da_config()
    for role in ("decoder", "forecast"):
        cfg["models"][role] = dict(da["models"][role], remat=cfg["models"][role]["remat"])
    flow = cfg["models"]["flow"]
    cfg["models"]["flow"] = dict(cfg["models"]["decoder"], inchans_list=flow["inchans_list"],
                                 outchans_list=flow["outchans_list"])
    cfg["da"].update({k: da["da"][k] for k in ("grid_hw", "solver_hw", "latent_shape",
                                                "obs_type", "init_lag")})
    return cfg


def micro_window_ctx(tmp_path, seed=2 ** 31 + 23, **kw):
    """A Ctx of the window cell at micro size on the CPU: two window cycles
    and the set-up one; `kw` replaces fields."""
    spec = harness.cell_file(CELL)
    args = dict(name=CELL, cell=spec, config=micro_window_config(), seed=seed,
                seconds=2 * spec["params"]["cycle_s_hint"], trace=False, device="cpu",
                start=time.perf_counter(), scratch=tmp_path)
    args.update(kw)
    return harness.Ctx(**args)
