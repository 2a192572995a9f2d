"""Build the package's CUDA sources into a shared library and load it.

Each `csrc/*.cu` file is compiled at first use with nvcc for sm_90a into
`<build dir>/lib<name>-<hash>.so`, where the hash covers the source, every
header under `csrc/` (`*.cuh`) and the flags, so an edited source or header
builds anew and an unchanged one is reused. The build directory is
$VAEVAR_TORCH_BUILD_DIR, else `vaevar_tpu_torch/_build/` (`build_dir`; an
installed copy whose package directory is read-only sets the variable). The
library has a plain C interface and is loaded with ctypes. A failed build
raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"  # the default build directory
BUILD_DIR_ENV = "VAEVAR_TORCH_BUILD_DIR"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def build_dir() -> Path:
    """Where the port's libraries are built: $VAEVAR_TORCH_BUILD_DIR, else
    the package's `_build/` (the CUDA kernels here and the native loader,
    data/native_loader.py)."""
    return Path(os.environ.get(BUILD_DIR_ENV) or BUILD_DIR)


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> tuple[Path, float]:
    """Compile csrc/<name>.cu unless an up-to-date library exists.
    Returns (library path, seconds spent compiling; 0.0 when reused)."""
    out = library_path(name)
    if out.exists():
        return out, 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed building {name}.cu (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out, secs


def build_all(names) -> dict[str, tuple[Path, float]]:
    """`build` each source, all nvcc processes started together."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        futures = {name: pool.submit(build, name) for name in names}
    return {name: f.result() for name, f in futures.items()}


def ptxas_report(log: str) -> dict[str, tuple[int, int, int]]:
    """Registers and spill bytes of each kernel in an `nvcc -Xptxas -v` log:
    {demangled name without the namespace: (registers, spill stores, spill
    loads)}."""
    found, name, spill = {}, None, (0, 0)
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            found[name] = (int(m.group(1)), *spill)
            name, spill = None, (0, 0)
    if not found:
        return {}
    names = subprocess.run(["c++filt"], input="\n".join(found), capture_output=True,
                           text=True).stdout.splitlines()
    return {pretty.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void "): v
            for pretty, v in zip(names, found.values())}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    path, _ = build(name)
    return ctypes.CDLL(str(path))
