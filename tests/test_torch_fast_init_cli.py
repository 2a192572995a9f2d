"""run_da --micro --fast_init: the JAX CLI and the port's CLI agree.

Both CLIs draw their models from --seed with --fast_init, and the port's draw
is now JAX's (tests/test_torch_fast_init.py), so with the same flags the two
packages cycle the same decoder (seed 0) and flow model (seed 1, the advance
at the solver grid) on the same synthetic truth and masks. JAX's
`python run_da.py` runs as a subprocess with JAX_PLATFORMS=cpu; the port's
`run_da.main` runs here with the same flags and --device cpu. Two 6 h
cycles after the 1-step spin-up, 3D-Var with Nit 4, in f32 (--no-bf16: the
comparison then measures the port's round-off, not bf16's; the default
bf16 rounds the activations, where different summation orders can land on
different sides of a bf16 step). Both packages' `auto` linesearch resolves
to jvp-zoom here, so it is not pinned.

Tolerances:
- J: JAX prints Jb and Jo per L-BFGS segment with 4 significant digits
  (`[vae4dvar] iter k: ... Jb x Jo y`); the port's J (full precision, from
  its cycle log) must lie within half a unit of the printed last digit, plus
  1e-5 relative for round-off.
- the background and analysis WRMSE dumps (bg_wrmse.npy, ana_wrmse.npy, full
  precision): relative 1e-5. Both sides run the same f32 operations in
  other summation orders through 2 cycles of 4 L-BFGS segments; the L-BFGS
  decisions are the same, so the differences stay at f32 round-off
  amplified by the solve (measured: 6.4e-7).
"""

import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from vaevar_tpu_torch import run_da

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
FLAGS = ["--micro", "--fast_init", "--grid", "32x64", "--solver_grid", "32x64", "--init_lag", "1",
         "--no-bf16", "--end_time", "2022-01-01 12:00:00"]
RTOL = 1e-5


def _jax_cycles(stdout):
    """[(time, [(Jb, Jo) per segment])] from JAX run_da's log."""
    cycles = []
    for line in stdout.splitlines():
        if line.startswith("cycle @ "):
            cycles.append((line[len("cycle @ "):].strip(), []))
        m = re.search(r"\] iter \d+: .* Jb (\S+) Jo (\S+)$", line)
        if m:
            cycles[-1][1].append((float(m.group(1)), float(m.group(2))))
    return cycles


def _printed_close(port, printed):
    """port within half a unit of printed's 4th significant digit, + RTOL."""
    half = 0.0 if printed == 0 else 0.5 * 10 ** (math.floor(math.log10(abs(printed))) - 3)
    return abs(port - printed) <= half * (1 + 1e-9) + RTOL * abs(printed)


def test_jax_and_port_cli_agree_with_fast_init(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    jax_proc = subprocess.Popen(
        [sys.executable, str(REPO / "run_da.py"), *FLAGS, "--work_dir", str(tmp_path / "jax")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=tmp_path)
    try:
        da = run_da.main([*FLAGS, "--device", "cpu", "--work_dir", str(tmp_path / "port")])
        out, err = jax_proc.communicate(timeout=300)
    finally:
        jax_proc.kill()
    assert jax_proc.returncode == 0, err[-3000:]

    jax_cycles = _jax_cycles(out)
    assert [t for t, _ in jax_cycles] == [str(c["time"]) for c in da.cycle_log] == [
        "2022-01-01 00:00:00", "2022-01-01 06:00:00"]
    for (t, printed), c in zip(jax_cycles, da.cycle_log):
        port = list(zip(c["jb"], c["jo"]))
        assert len(port) == len(printed) == 5, t
        for k, ((pb, po), (jb, jo)) in enumerate(zip(port, printed)):
            assert _printed_close(pb, jb) and _printed_close(po, jo), (t, k, pb, jb, po, jo)

    (jdir,) = (tmp_path / "jax").glob("run_*")
    (pdir,) = (tmp_path / "port").glob("run_*")
    assert jdir.name == pdir.name
    for name in ("bg_wrmse", "ana_wrmse"):
        want, got = np.load(jdir / f"{name}.npy"), np.load(pdir / f"{name}.npy")
        assert got.shape == want.shape == (2, 69)
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=name)
