"""The port's meters and timers (utils/meters.py, utils/logger.py) against
the JAX package's, side by side.

- SmoothedValue and MetricLogger: the cases of tests/test_primitives.py's
  TestMeters, each run through both packages' classes on equal inputs,
  with equal outputs (the logged lines equal up to their timings);
- synchronize_between_processes over 2 processes with gloo: count and
  total summed over the ranks, as JAX's process_allgather sums them
  (vaevar_tpu/utils/meters.py:40-50), the window left local; a no-op with
  no process group;
- PhaseTimer.report() byte for byte against JAX's for the same recorded
  totals;
- device_trace on the CPU writes a Chrome trace into log_dir, and does
  nothing without one.
"""

import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from vaevar_tpu.utils import logger as jlogger
from vaevar_tpu.utils import meters as jmeters
from vaevar_tpu_torch.utils import logger as tlogger
from vaevar_tpu_torch.utils import meters as tmeters

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def _state(s):
    return (s.value, s.median, s.avg, s.global_avg, s.max, s.count, s.total, str(s))


@pytest.mark.parametrize("window, values", [(3, [1.0, 2.0, 3.0, 4.0]), (20, [0.5, -2.0, 7.25]),
                                            (2, [3, 1, 4, 1, 5, 9, 2, 6])])
def test_smoothed_value_equals_jax(window, values):
    j, t = jmeters.SmoothedValue(window_size=window), tmeters.SmoothedValue(window_size=window)
    assert _state(t) == _state(j)  # empty
    for v in values:
        j.update(v, n=2)
        t.update(v, n=2)
        assert _state(t) == _state(j)
    j.synchronize_between_processes()  # no process group: no-op in both
    t.synchronize_between_processes()
    assert _state(t) == _state(j)


def test_primitives_case_smoothed_value():
    """tests/test_primitives.py::TestMeters::test_smoothed_value on the port."""
    s = tmeters.SmoothedValue(window_size=3)
    for v in [1.0, 2.0, 3.0, 4.0]:
        s.update(v)
    assert s.value == 4.0 and s.median == 3.0
    assert abs(s.avg - 3.0) < 1e-9
    assert abs(s.global_avg - 2.5) < 1e-9
    s.synchronize_between_processes()
    assert s.count == 4


def _log_lines(mod, capsys):
    ml = mod.MetricLogger()
    ml.add_meter("lr", mod.SmoothedValue(window_size=1, fmt="{value:.6f}"))
    for i in ml.log_every(range(5), print_freq=2, header="ep0"):
        ml.update(loss=float(i), lr=1e-3 / (i + 1))
    out = capsys.readouterr().out
    assert abs(ml.meters["loss"].global_avg - 2.0) < 1e-9 and ml.loss is ml.meters["loss"]
    # the step and data timings and the duration are wall-clock: mask them
    return re.sub(r"(time: |data: |done in )\d+\.\d+", r"\1T", out).splitlines()


def test_metric_logger_equals_jax(capsys):
    """tests/test_primitives.py::TestMeters::test_metric_logger_iterates,
    with both packages' loggers printing the same lines."""
    lines = _log_lines(jmeters, capsys)
    assert _log_lines(tmeters, capsys) == lines
    assert len(lines) == 4 and "ep0" in lines[0] and "loss: " in lines[1]
    assert lines[-1] == "ep0 done in Ts"


WORKER = r"""
import json, sys
import torch.distributed as dist
from vaevar_tpu_torch.utils.meters import MetricLogger, SmoothedValue
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=2)
s = SmoothedValue(window_size=2)
for v in ([1.0, 2.0, 3.0] if rank == 0 else [10.0, 20.0]):
    s.update(v, n=rank + 1)
ml = MetricLogger()
ml.update(loss=rank + 0.5)
s.synchronize_between_processes()
ml.synchronize_between_processes()
print(json.dumps({"count": s.count, "total": s.total, "median": s.median,
                  "global_avg": s.global_avg, "loss": [ml.loss.count, ml.loss.total]}))
dist.destroy_process_group()
"""


def test_synchronize_between_two_gloo_processes(tmp_path):
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(port)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=tmp_path) for r in (0, 1)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    # rank 0: 3 values of weight 1 (total 6); rank 1: 2 of weight 2 (total 60)
    for r, o in enumerate(outs):
        assert (o["count"], o["total"]) == (3 + 4, 6.0 + 60.0)
        assert o["global_avg"] == 66.0 / 7
        assert o["median"] == (3.0 if r == 0 else 20.0)  # the window stays local
        assert o["loss"] == [2, 2.0]


def test_phase_timer_report_equals_jax():
    j, t = jlogger.PhaseTimer(), tlogger.PhaseTimer()
    for timer in (j, t):
        with timer.phase("solve"):
            pass
        timer.totals.update({"solve": 12.3456, "obs": 0.0049, "total": 1000.0})
        timer.counts.update({"solve": 3, "obs": 1, "total": 1})
    assert t.report() == j.report()
    assert t.report().splitlines()[0] == "obs: total 0.00s x1 (avg 0.005s)"


def test_device_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with tlogger.device_trace(None):
        pass
    assert not list(tmp_path.iterdir())  # no log_dir: nothing recorded or written
    with tlogger.device_trace(str(tmp_path / "trace")):
        x = torch.randn(64, 64)
        (x @ x).sum()
    (path,) = (tmp_path / "trace").glob("trace_*.json")
    trace = json.loads(path.read_text())
    ops = {e.get("name") for e in trace["traceEvents"] if e.get("cat") == "cpu_op"}
    assert {"aten::randn", "aten::mm", "aten::sum"} <= ops
