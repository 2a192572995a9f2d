"""ctypes bindings for the native C++ prefetching data loader.

A copy of vaevar_tpu/data/native_loader.py for the port: the same threaded
C++ reader pool and ring buffer (native/dataloader.cc) behind the same
Python surface (`NativePrefetcher`, `LoaderSampleError`, `available`,
`build`). The port builds its own library: at first use it compiles
native/dataloader.cc with g++ and the flags of native/Makefile into
`<build dir>/libvvloader-<hash>.so` (the hash covers the source and the
flags; the directory is ops/_build.py's `build_dir`: $VAEVAR_TORCH_BUILD_DIR,
else `vaevar_tpu_torch/_build/`) and loads that copy. It never runs
`make -C native`, which would rewrite the tracked native/libvvloader.so. `available()` is False
when the library cannot be built (no g++).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Sequence

import numpy as np

from vaevar_tpu_torch.ops._build import build_dir

SOURCE = Path(__file__).resolve().parents[2] / "native" / "dataloader.cc"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return build_dir() / f"libvvloader-{h.hexdigest()[:16]}.so"


def build() -> bool:
    """Compile native/dataloader.cc into the port's build directory unless
    an up-to-date library is there; True when the library exists."""
    out = library_path()
    if out.exists():
        return True
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        r = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp),
                            str(SOURCE)], capture_output=True, text=True)
    except FileNotFoundError:  # no compiler
        return False
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


@functools.cache
def _load():
    if not build():
        return None
    lib = ctypes.CDLL(str(library_path()))
    lib.vvl_create.restype = ctypes.c_void_p
    lib.vvl_create.argtypes = [ctypes.c_long, ctypes.c_long, ctypes.c_int]
    lib.vvl_set_norm.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_long,
    ]
    lib.vvl_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.vvl_submit_tagged.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
    ]
    lib.vvl_next_tagged.restype = ctypes.c_int
    lib.vvl_next_tagged.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_long),
        ctypes.c_int,
    ]
    lib.vvl_next.restype = ctypes.c_int
    lib.vvl_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
    ]
    lib.vvl_pending.restype = ctypes.c_long
    lib.vvl_pending.argtypes = [ctypes.c_void_p]
    lib.vvl_destroy.argtypes = [ctypes.c_void_p]
    return lib


class LoaderSampleError(IOError):
    """A submitted sample failed to read. Carries the submit `tag` (or -1
    if unknown) so consumers with epoch-encoded tags can discard failures
    belonging to stale, already-abandoned submissions instead of aborting
    the current batch."""

    def __init__(self, msg: str, tag: int = -1):
        super().__init__(msg)
        self.tag = tag


def available() -> bool:
    return _load() is not None


class NativePrefetcher:
    """Prefetches whole .npy samples (e.g. one (69, H, W) frame each)."""

    def __init__(
        self,
        sample_shape: Sequence[int],
        capacity: int = 8,
        n_threads: int = 4,
        normalize: bool = False,
    ):
        lib = _load()
        if lib is None:
            raise RuntimeError("native loader could not be built (g++ -shared of "
                               "native/dataloader.cc)")
        self._lib = lib
        self.sample_shape = tuple(sample_shape)
        self._n = int(np.prod(self.sample_shape))
        self._h = lib.vvl_create(capacity, self._n, n_threads)
        if normalize:
            from vaevar_tpu_torch import channels

            chan_stride = int(np.prod(self.sample_shape[-2:]))
            mean = np.ascontiguousarray(channels.MEAN, np.float32)
            std = np.ascontiguousarray(channels.STD, np.float32)
            lib.vvl_set_norm(
                self._h,
                mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                len(mean),
                chan_stride,
            )

    def submit(self, path: str, tag: int | None = None):
        if tag is None:
            self._lib.vvl_submit(self._h, path.encode())
        else:
            self._lib.vvl_submit_tagged(self._h, path.encode(), tag)

    def next(self, timeout_ms: int = 30_000) -> np.ndarray | None:
        out = np.empty(self._n, np.float32)
        r = self._lib.vvl_next(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), timeout_ms
        )
        if r == 1:
            return out.reshape(self.sample_shape)
        if r == 0:
            return None
        raise IOError("native loader failed to read a sample")

    def next_tagged(
        self, timeout_ms: int = 30_000
    ) -> tuple[np.ndarray, int] | None:
        """(sample, submit tag). Completion order across reader threads is
        NOT submit order — the tag identifies which submit this is."""
        out = np.empty(self._n, np.float32)
        tag = ctypes.c_long(-1)
        r = self._lib.vvl_next_tagged(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(tag), timeout_ms,
        )
        if r == 1:
            return out.reshape(self.sample_shape), int(tag.value)
        if r == 0:
            return None
        # the C side sets tag_out before returning -1, so the failure is
        # attributable to a specific submit
        raise LoaderSampleError(
            "native loader failed to read a sample", tag=int(tag.value)
        )

    def pending(self) -> int:
        return int(self._lib.vvl_pending(self._h))

    def close(self):
        if self._h:
            self._lib.vvl_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
