"""Helpers of the benchmark's tests: the benchmark's folder and the
repository's root on the import path, and micro-size copies of the two
configurations (the CPU stands in for the card, in float32). The tests:

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
for p in (str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402

MICRO_MODEL = dict(enc_dim=8, embed_dim=64, enc_depths=[1, 1], enc_heads=[1, 2],
                   lg_depths=[1, 1], lg_heads=[2, 2], dtype="float32")


def micro_da_config():
    """vaevar_da_025 at 64x128 with a 32x64 solver grid and micro models:
    the rope forecast model's full-grid stage takes the flash path
    (flash_min_seq 16), the decoder keeps relbias."""
    cfg = harness.config_file("vaevar_da_025")
    cfg["models"]["decoder"].update(MICRO_MODEL, img_size=[32, 64], embed_dim=32,
                                    enc_heads=[1, 1])
    cfg["models"]["forecast"].update(MICRO_MODEL, img_size=[64, 128], patch_size=[2, 2],
                                     window_size=[4, 8], flash_min_seq=16)
    cfg["da"].update(grid_hw=[64, 128], solver_hw=[32, 64], latent_shape=[1, 32, 32, 64],
                     obs_type="column_random_0100", nit=2, init_lag=2)
    return cfg


def micro_train_config():
    cfg = harness.config_file("forecast_025")
    cfg["model"].update(MICRO_MODEL, img_size=[64, 128], patch_size=[2, 2], window_size=[4, 8],
                        flash_min_seq=16)
    return cfg


def micro_ctx(name: str, tmp_path, seed=2 ** 31 + 17, **kw):
    """A Ctx of the cell `name` at micro size on the CPU; `kw` replaces
    fields."""
    import time

    spec = harness.cell_file(name)
    cfg = micro_da_config() if spec["driver"] == "da_cycle" else micro_train_config()
    seconds = 2 * spec["params"].get("cycle_s_hint", 1.0)
    args = dict(name=name, cell=spec, config=cfg, seed=seed, seconds=seconds, trace=False,
                device="cpu", start=time.perf_counter(), scratch=tmp_path)
    args.update(kw)
    return harness.Ctx(**args)
