"""Time variants of the flash kernels against each other on one GPU.

    python3 scripts/kernel_variants.py VARIANTS.json

VARIANTS.json maps a name to text edits of the sources in
vaevar_tpu_torch/csrc ({"flash_fwd.cu": [[old, new], ...]}), optionally on
a copy of another csrc directory ("__dir__": path); {} is the tree as it
stands; a variant may also drop a stage (a "part_" variant, whose results
are wrong by design) to show what that stage costs. Each variant is built
in a temporary directory (one nvcc per source, all started together) and
its registers and spills at head dim 192 are printed. Then, at the
production shape (1, 6, 16200, 192), with the main
path's dtypes (f32 q/k/dO, bf16 v) and in bf16, each variant's forward, dq
and dkv kernels are checked against the plain versions and timed in turns:
the variants in order, then in reverse, medians of 5 CUDA-event runs each.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from vaevar_tpu_torch.ops import _build  # noqa: E402
from vaevar_tpu_torch.ops import flash_attn as fa  # noqa: E402

SOURCES = ("flash_fwd", "flash_bwd")


def build(variants, root):
    """Copy, edit and compile each variant; returns {(variant, source): CDLL}."""
    procs = {}
    for name, spec in variants.items():
        spec = dict(spec)
        d = root / name
        shutil.copytree(spec.pop("__dir__", _build.CSRC), d)
        for file, edits in spec.items():
            text = (d / file).read_text()
            for old, new in edits:
                if old not in text:
                    raise ValueError(f"{name}: {file} has no {old!r}")
                text = text.replace(old, new)
            (d / file).write_text(text)
        for src in SOURCES:
            procs[name, src] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / f"lib{src}.so"),
                 str(d / f"{src}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (name, src), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed on {src}.cu:\n{log}")
        report(name, log)
        libs[name, src] = ctypes.CDLL(str(root / name / f"lib{src}.so"))
    return libs


def report(name, log):
    """Print registers and spills of every head-dim-192 kernel in a build log."""
    for kernel, (regs, spill_st, spill_ld) in _build.ptxas_report(log).items():
        if "192>" in kernel:
            print(f"{name}: {kernel} {regs} registers, spill stores/loads {spill_st}/{spill_ld} "
                  "bytes", flush=True)


def use(libs, name):
    """Point the wrappers of ops/flash_attn.py at variant `name`'s libraries."""
    fwd = libs[name, "flash_fwd"].flash_fwd
    fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    lib = libs[name, "flash_bwd"]
    lib.flash_bwd_dq.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.flash_bwd_dkv.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.flash_bwd_dq.restype = lib.flash_bwd_dkv.restype = ctypes.c_int
    fa._fwd_fn = lambda: fwd
    fa._bwd_fns = lambda: (lib.flash_bwd_dq, lib.flash_bwd_dkv)


def main(path):
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: no CUDA device available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    variants = json.loads(Path(path).read_text())
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(variants, Path(tmp))
        shape, names = cs.PROD_SHAPE, list(variants)
        for key, (qk, vt) in (("main", (torch.float32, torch.bfloat16)),
                              ("bf16", (torch.bfloat16, torch.bfloat16))):
            q = cs.rand(shape, 1, torch.float32, shape[-1] ** -0.5).to(qk)
            k = cs.rand(shape, 2, torch.float32).to(qk)
            v = cs.rand(shape, 3, torch.float32).to(vt)
            do = cs.rand(shape, 4, torch.float32).to(qk)
            o_ref, lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), 1024, 1024)
            delta = (do.float() * o_ref).sum(-1)
            dq_ref = fa.flash_dq_plain(q.float(), k.float(), v.float(), do.float(), lse, delta)
            dk_ref, dv_ref = fa.flash_dkv_plain(q.float(), k.float(), v.float(), do.float(), lse,
                                                delta)
            runs = {"fwd": lambda: fa.flash_fwd_cuda(q, k, v),
                    "dq": lambda: fa.flash_dq_cuda(q, k, v, do, lse, delta),
                    "dkv": lambda: fa.flash_dkv_cuda(q, k, v, do, lse, delta)}
            for name in names:
                use(libs, name)
                o, _ = runs["fwd"]()
                dq, (dk, dv) = runs["dq"](), runs["dkv"]()
                errs = [(o.float() - o_ref).abs().max().item()] + [
                    ((a.float() - b).abs().max() / b.abs().max()).item()
                    for a, b in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref))]
                print(f"{key} {name}: max|dO| {errs[0]:.3g}; dq, dk, dv max|d| / max|ref| "
                      f"{errs[1]:.3g}, {errs[2]:.3g}, {errs[3]:.3g}", flush=True)
            times = {name: {kern: [] for kern in runs} for name in names}
            for name in names + names[::-1]:
                use(libs, name)
                for kern, fn in runs.items():
                    times[name][kern].append(cs.median_ms(fn))
            for name in names:
                print(f"{key} {name}: " + "; ".join(
                    f"{kern} {statistics.mean(t):.3f} ms ({t[0]:.3f}/{t[1]:.3f})"
                    for kern, t in times[name].items()), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
