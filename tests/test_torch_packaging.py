"""An installed copy of the PyTorch port carries what it builds and reads at
run time: the CUDA sources under vaevar_tpu_torch/csrc/ (MANIFEST.in) and
the OSSE's initial weights, and it builds its libraries where
$VAEVAR_TORCH_BUILD_DIR says (ops/_build.py::build_dir). CPU only: the wheel
is built offline from the files git would commit, and no nvcc is run."""

import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

from vaevar_tpu_torch.data import native_loader
from vaevar_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parents[1]
CARRIED = ("vaevar_tpu_torch/csrc/flash_fwd.cu", "vaevar_tpu_torch/csrc/flash_bwd.cu",
           "vaevar_tpu_torch/csrc/mma_sm90.cuh", "vaevar_tpu_torch/osse_vae_init.npz")


def _committed_files():
    """The files git would commit (tracked, or new and not ignored)."""
    out = subprocess.run(["git", "ls-files", "-co", "--exclude-standard", "-z"], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    return [f for f in out.split("\0") if f and (REPO / f).is_file()]


@pytest.fixture(scope="module")
def wheel_names(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wheel")
    src = tmp / "src"
    for f in _committed_files():
        (src / f).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(REPO / f, src / f)
    # a library left by an earlier build must not ship
    lib = src / "vaevar_tpu_torch" / "_build" / "libflash_fwd-0123456789abcdef.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    lib.write_bytes(b"\0")
    subprocess.run([sys.executable, "-m", "pip", "wheel", str(src), "--no-deps",
                    "--no-build-isolation", "--no-index", "-q", "-w", str(tmp / "out")],
                   check=True, capture_output=True, text=True)
    (whl,) = (tmp / "out").glob("*.whl")
    return set(zipfile.ZipFile(whl).namelist())


def test_wheel_carries_the_sources_and_the_osse_weights(wheel_names):
    assert set(CARRIED) <= wheel_names
    assert "vaevar_tpu_torch/ops/_build.py" in wheel_names
    assert "vaevar_tpu_torch/da/cycler.py" in wheel_names


def test_wheel_holds_no_built_library(wheel_names):
    assert not [n for n in wheel_names if "/_build/" in n or n.endswith(".so")]


def test_build_dir_moves_both_libraries_and_keeps_their_names(tmp_path, monkeypatch):
    monkeypatch.delenv(_build.BUILD_DIR_ENV, raising=False)
    default = {"flash_fwd": _build.library_path("flash_fwd"),
               "flash_bwd": _build.library_path("flash_bwd"),
               "vvloader": native_loader.library_path()}
    assert {p.parent for p in default.values()} == {REPO / "vaevar_tpu_torch" / "_build"}
    target = tmp_path / "libs"
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(target))
    moved = {"flash_fwd": _build.library_path("flash_fwd"),
             "flash_bwd": _build.library_path("flash_bwd"),
             "vvloader": native_loader.library_path()}
    assert {p.parent for p in moved.values()} == {target}
    assert {k: p.name for k, p in moved.items()} == {k: p.name for k, p in default.items()}
    # the native loader builds into the moved directory (g++ only)
    if shutil.which("g++"):
        assert native_loader.build() and moved["vvloader"].exists()
        assert os.listdir(target) == [moved["vvloader"].name]
