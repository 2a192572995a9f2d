"""The build cache of the CUDA kernels (vaevar_tpu_torch/ops/_build.py).

`library_path` names the shared library after a hash of the source, the
headers under csrc/ and the nvcc flags, so an edited source or header builds
anew. No nvcc is needed: only the path is computed."""

import shutil

from vaevar_tpu_torch.ops import _build


def _copy_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    return csrc


def test_library_path_covers_every_header(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the kernels share a header under csrc/"
    before = {name: _build.library_path(name) for name in ("flash_fwd", "flash_bwd")}
    assert _build.library_path("flash_fwd") == before["flash_fwd"]  # stable
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in before}
    assert all(after[name] != before[name] for name in before)
    (csrc / "extra.cuh").write_text("#pragma once\n")  # a new header counts too
    assert _build.library_path("flash_fwd") != after["flash_fwd"]


def test_library_path_covers_the_source_and_flags(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    before = _build.library_path("flash_fwd")
    assert before.parent == _build.BUILD_DIR and before.name.startswith("libflash_fwd-")
    src = csrc / "flash_fwd.cu"
    src.write_text(src.read_text() + "\n")
    edited = _build.library_path("flash_fwd")
    assert edited != before
    assert _build.library_path("flash_bwd") == _build.library_path("flash_bwd")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path("flash_fwd") != edited
