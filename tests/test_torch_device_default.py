"""The port's public DA entry points run on the card unless asked for the CPU.

JAX's CycledDA runs on the default accelerator; the port's `CycledDA` and
`osse.build_world`, `osse.cycle` and `osse.run_cycles` default to "cuda".
Without a card a call that leaves the default raises a clear error, before
any work, and never falls back to the CPU; device="cpu" runs on the CPU.
"""

import dataclasses
import inspect

import pytest
import torch

from vaevar_tpu_torch import osse
from vaevar_tpu_torch.config import DAConfig
from vaevar_tpu_torch.da.cycler import CycledDA

CFG = DAConfig(da_mode="free_run", grid_hw=(32, 64), solver_hw=(32, 64))
ENTRY_POINTS = [osse.build_world, osse.cycle, osse.run_cycles]


def test_defaults_are_the_card():
    assert {f.name: f.default for f in dataclasses.fields(CycledDA)}["device"] == "cuda"
    for fn in ENTRY_POINTS:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default runs there")


def test_cycler_without_a_card_raises(tmp_path):
    _no_card()
    with pytest.raises(RuntimeError, match=r"'cuda': no CUDA device is available; "
                                           r"pass device='cpu'"):
        CycledDA(CFG, None, None, work_dir=str(tmp_path / "w"))
    assert not (tmp_path / "w").exists()  # refused before any work
    da = CycledDA(CFG, None, None, work_dir=str(tmp_path / "w"), device="cpu")
    assert da.device == "cpu"


@pytest.mark.parametrize("fn", ENTRY_POINTS, ids=lambda f: f.__name__)
def test_osse_without_a_card_raises(fn, tmp_path):
    _no_card()
    args = {"build_world": (), "cycle": (None, "free_run", str(tmp_path)),
            "run_cycles": (None, str(tmp_path))}[fn.__name__]
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        fn(*args)
