"""The prepbufr station family on the port against the JAX package: micro
vae4dvar cycles at da_win 1 and 6, and the family's construction guards.

The set-up and tolerances are tests/test_torch_da_surface.py's (bridged
micro decoder and forecast model, the same truth and synthetic station
network on both sides; Jb, Jo, fields and metrics rtol 1e-3 with a floor
of 1e-5 x the channel std). The obs (the station mask, R with the model
error Q, the truth as obs) are compared bitwise: the same numpy gridding.
A file of its own so that each parity file runs in about a minute.
"""

import numpy as np
import pytest
import torch

from test_torch_da_surface import (  # noqa: F401 (models: the shared fixture)
    DA_KW, GRID, _pair, _solve_cycle_matches_jax, models)
from vaevar_tpu_torch.config import DAConfig as TorchDAConfig
from vaevar_tpu_torch.da.cycler import CycledDA as TorchCycledDA

torch.set_num_threads(1)


@pytest.mark.parametrize("da_win", [1, 6])
def test_prepbufr_cycle_matches_jax(models, tmp_path, da_win):
    """prepbufr: the 69-channel mask gridded from the reports (at da_win 6
    from two report files, times spread over +-3 h), the truth as obs, the
    reduced cost (at da_win 6 the window cost with a persistence flow)."""
    jda, tda = _pair(models, tmp_path, da_win=da_win, obs_type="prepbufr",
                     dt=(-3.0, 3.0) if da_win > 1 else (0.0, 0.0))
    assert tda._reducible
    (_, jH, jR, jgt), (tyo, tH, tR, tgt), _ = _solve_cycle_matches_jax(jda, tda, tmp_path,
                                                                       counts=False)
    np.testing.assert_array_equal(tH.numpy(), np.asarray(jH))
    np.testing.assert_array_equal(tR.numpy(), np.asarray(jR))
    np.testing.assert_array_equal(tyo.numpy(), np.asarray(jgt))
    assert tH.shape == (da_win, 69, *GRID)
    assert all(float(tH[t].sum()) > 0 for t in range(da_win))


def test_station_obs_guards(tmp_path):
    """prepbufr takes da_win 1 or 6 and a report source, real obs a report
    source or pre-gridded files: each refused at construction."""
    cfg = TorchDAConfig(**{**DA_KW, "obs_type": "prepbufr", "da_win": 3})
    kw = dict(work_dir=str(tmp_path / "w"))
    with pytest.raises(NotImplementedError, match="da_win must be 1 or 6"):
        TorchCycledDA(cfg, None, None, torch.nn.Identity(), reports_source=object(), **kw)
    with pytest.raises(ValueError, match="needs a reports_source"):
        TorchCycledDA(cfg.replace(da_win=1), None, None, torch.nn.Identity(), **kw)
    with pytest.raises(ValueError, match="needs a reports_source or obs_from_numpy"):
        TorchCycledDA(cfg.replace(obs_type="real_simu"), None, None, torch.nn.Identity(), **kw)
    assert not (tmp_path / "w").exists()
