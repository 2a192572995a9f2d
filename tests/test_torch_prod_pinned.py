"""Production-geometry parity of the port against JAX's pinned golden.

tests/test_prod_geometry_pinned.py pins the JAX package's one-cycle result
at real shapes in tests/goldens/prod_geometry_pinned.json: VAE_DECODER
(215.9 M parameters, f32) from fast_init seed 0, latent (1, 32, 128, 256),
the 1.4 deg grid, free_0010 obs and one pass through the production
reduced-obs cycler path (da_4dvar.py:1238-1306 semantics). Since the port's
fast_init draws JAX's weights (tests/test_torch_fast_init.py), the same
construction on the port must give the same summary: `compute_summary` is
JAX's line for line, with the port's modules, and the golden is read, never
written. The tolerances are JAX's own (relative 5e-3 on each of the six
scalars, 1e-2 on the increment probe); both sides compute in f32 with the
same weights and inputs, so they differ by round-off alone.

Slow on the CPU, like JAX's test (a 216 M-parameter decoder at 128x256):
`python -m pytest -m slow tests/test_torch_prod_pinned.py`. The test imports
no jax, so on the card it runs as chip_smoke.py's `pinned` phase, which
builds the decoder through the port's run_da and calls `compute_summary` and
`relative_errors` from here.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import pytest

pytestmark = pytest.mark.slow

ART = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                   "prod_geometry_pinned.json")
SCALARS = ("z500_ana_wrmse", "t850_ana_wrmse", "t2m_ana_wrmse", "inc_norm", "xa_norm",
           "bg_z500_wrmse")
RTOL_SCALAR, RTOL_PROBE = 5e-3, 1e-2  # tests/test_prod_geometry_pinned.py:126-135


def compute_summary(device="cpu", decoder=None):
    """The pinned quantities of tests/test_prod_geometry_pinned.py::
    compute_summary on the port, on `device`. `decoder`: the VAE_DECODER to
    use (default: built here from fast_init seed 0, f32)."""
    import torch

    from vaevar_tpu_torch import channels
    from vaevar_tpu_torch import config as cfgs
    from vaevar_tpu_torch.da import obs as obs_mod
    from vaevar_tpu_torch.da.cycler import CycledDA
    from vaevar_tpu_torch.data.era5 import SyntheticEra5
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.utils.fast_init import fast_init
    from vaevar_tpu_torch.utils.metrics import weighted_rmse

    HW = (128, 256)
    MEAN3 = channels.MEAN.reshape(-1, 1, 1).astype(np.float32)
    STD3 = channels.STD.reshape(-1, 1, 1).astype(np.float32)
    torch.backends.cuda.matmul.allow_tf32 = False  # as run_da sets them
    torch.backends.cudnn.allow_tf32 = False

    if decoder is None:
        decoder = fast_init(LGUnet(cfgs.VAE_DECODER), seed=0).to(device)

    rng = np.random.default_rng(0)
    gt0 = (MEAN3 + STD3 * rng.normal(size=(69, *HW))).astype(np.float32)
    gt = gt0[None]
    xb = (gt0 + 0.5 * STD3 * rng.normal(size=(69, *HW))).astype(np.float32)
    H = obs_mod.make_obs_mask("free_0010", 1, HW, rng).astype(np.float32)
    R = obs_mod.build_R(obs_mod.obs_error_variance(0.005, 2), None, 1).astype(np.float32)
    yo = gt.copy()

    da_cfg = cfgs.DAConfig(
        da_mode="vae4dvar", da_win=1, nit=1, lbfgs_iters=2,
        obs_std=0.005, modify_tp=2, obs_type="free_0010", q_type=-1,
        grid_hw=HW, solver_hw=HW, latent_shape=(1, 32, *HW),
        init_tp=1, init_lag=1,
    )

    def dev(a):
        return torch.as_tensor(a, device=device)

    with tempfile.TemporaryDirectory() as work:
        da = CycledDA(da_cfg, SyntheticEra5(hw=HW, seed=5),
                      lambda x, steps, interpolation=False: x, decoder=decoder,
                      work_dir=work, verbose=False, device=device)
        xa = da.one_step_da(dev(gt), dev(xb), dev(yo), dev(H), dev(R)).cpu().numpy()

    def wrmse(x):
        n = torch.as_tensor((x - MEAN3) / STD3)[None]
        return weighted_rmse(n, torch.as_tensor((gt0 - MEAN3) / STD3)[None]).numpy() \
            * channels.STD

    w = wrmse(xa)
    inc = xa - xb
    return {
        "z500_ana_wrmse": float(w[11]),
        "t850_ana_wrmse": float(w[66]),
        "t2m_ana_wrmse": float(w[2]),
        "inc_norm": float(np.linalg.norm(inc)),
        "xa_norm": float(np.linalg.norm(xa)),
        "inc_probe": np.round(inc[::17, ::31, ::53].astype(np.float64), 5).reshape(-1).tolist(),
        "bg_z500_wrmse": float(wrmse(xb)[11]),
    }


def relative_errors(got: dict, pinned: dict) -> dict:
    """{name: relative error} of the six scalars and of the probe (its
    2-norm), as tests/test_prod_geometry_pinned.py measures them."""
    out = {k: abs(got[k] - pinned[k]) / max(abs(pinned[k]), 1e-12) for k in SCALARS}
    probe_g, probe_p = np.asarray(got["inc_probe"]), np.asarray(pinned["inc_probe"])
    assert probe_g.shape == probe_p.shape
    out["inc_probe"] = float(np.linalg.norm(probe_g - probe_p)
                             / max(np.linalg.norm(probe_p), 1e-12))
    return out


def misses(rel: dict) -> list[str]:
    return [k for k, v in rel.items() if not v < (RTOL_PROBE if k == "inc_probe" else RTOL_SCALAR)]


def test_port_matches_jax_pinned_golden():
    with open(ART) as f:
        pinned = json.load(f)
    rel = relative_errors(compute_summary("cpu"), pinned)
    assert not misses(rel), rel
