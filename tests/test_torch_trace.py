"""The port's spans and counters (vaevar_tpu_torch/utils/trace.py) and the
places that record them.

- Off (the default): `span` hands back one shared no-op context, keeps
  nothing and makes no CUDA event, even for a device span.
- On: nesting, parent ids and request ids, per thread; device spans make
  their two events only where CUDA is initialised and resolve them in
  `records()`; `enable` drops older spans, `disable` stops new ones.
- Counters: always on, exact under many threads; `write_jsonl` and
  `exported` (the CLIs' `--spans`) round trip.
- A CUDA graph capture (`tallied`, with a stand-in for the capturing
  stream): what counts on the capturing thread goes to the tally and not to
  the counters, its host spans record nothing and its device spans make
  external timing events, while another thread counts and spans as ever;
  each `Tally.replayed()` adds the tally to the counters and, while tracing
  is on, records each device span with its events' time.
- The clock: a torch profiler CPU op's `ts` + `baseTimeNanoseconds` lies
  inside the span that ran it.
- L-BFGS: one `lbfgs.probe` per value and gradient, jvp or restore the
  minimisation ran, and the counters agree with the result's counts.
- A CPU micro run_da: the span tree of a cycle (obs.prepare on the
  prefetch worker), one probe per eval the solver ran (the cycle log's
  n_evals, n_restore and the first segment's entry eval), and tracing on
  changes no number of the cycle log or the analysis.
- A micro forecast train step: the `train.*` spans once per step, and the
  loss and parameters bitwise equal with tracing on and off;
  run_train_forecast --spans writes a `train.loss_read` per step.
- On the card (`-m gpu`): a marker kernel's device start lies inside the
  host span that launched it, within 2 ms of its end.
"""

import json
import sys
import threading
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from vaevar_tpu_torch.da.lbfgs import lbfgs_minimize
from vaevar_tpu_torch.utils import capture, trace

torch.set_num_threads(1)
MICRO_DA = ["--device", "cpu", "--micro", "--fast_init", "--grid", "32x64", "--solver_grid",
            "16x32", "--init_lag", "1", "--Nit", "2", "--end_time", "2022-01-01 12:00:00",
            "--save_field"]
TIMINGS = {"seconds", "obs_s", "obs_wait_s", "reduce_s", "solve_s"}


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and no spans kept."""
    trace.enable()
    trace.disable()
    yield
    trace.enable()
    trace.disable()


def _diff(before):
    return {k: v - before.get(k, 0) for k, v in trace.counters().items()
            if v != before.get(k, 0)}


class _NoEvent:
    def __init__(self, *a, **k):
        raise AssertionError("a CUDA event was made")


def test_off_records_nothing_and_makes_no_event(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _NoEvent)
    a, b = trace.span("a"), trace.span("b", request=3, device=True, k=1)
    assert a is b and not trace.enabled()
    with a, b:
        pass
    assert trace.records() == []


def test_device_span_without_cuda_makes_no_event(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "Event", _NoEvent)
    trace.enable()
    with trace.span("advance", device=True):
        pass
    (r,) = trace.records()
    assert r["name"] == "advance" and r["device_ms"] is None


def test_device_span_resolves_its_events_in_records(monkeypatch):
    log = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.n = len(log)
            log.append("made")

        def record(self):
            log.append(f"record {self.n}")

        def synchronize(self):
            log.append(f"sync {self.n}")

        def elapsed_time(self, end):
            return 2.5 * (end.n - self.n)

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    trace.enable()
    with trace.span("train.backward", device=True):
        assert log == ["made", "made", "record 0"]
    assert log[-1] == "record 1"  # nothing waits while the span runs
    (r,) = trace.records()
    assert log[-1] == "sync 1" and r["device_ms"] == 2.5


def test_nesting_parents_and_order():
    trace.enable()
    with trace.span("cycle", request=7) as root:
        with trace.span("solve"):
            with trace.span("lbfgs.probe", kind="grad"):
                pass
        with trace.span("advance"):
            pass
    recs = trace.records()
    assert [r["name"] for r in recs] == ["cycle", "solve", "lbfgs.probe", "advance"]
    by = {r["name"]: r for r in recs}
    assert by["cycle"]["parent"] is None and by["cycle"]["id"] == root.id
    assert by["solve"]["parent"] == by["advance"]["parent"] == root.id
    assert by["lbfgs.probe"]["parent"] == by["solve"]["id"]
    assert by["lbfgs.probe"]["attrs"] == {"kind": "grad"}
    for r in recs:
        assert r["request"] == 7 and r["thread"] == threading.current_thread().name
        assert by["cycle"]["start_ns"] <= r["start_ns"] <= r["end_ns"] <= by["cycle"]["end_ns"]
    assert by["solve"]["end_ns"] <= by["advance"]["start_ns"]


def test_request_ids_given_or_inherited():
    trace.enable()
    with trace.span("train.step", request=0):
        with trace.span("train.forward_loss"):
            pass
    with trace.span("cycle", request=4):
        with trace.span("obs.take", request=5):
            with trace.span("host_sync"):
                pass
    with trace.span("orphan"):
        pass
    got = [(r["name"], r["request"]) for r in trace.records()]
    assert got == [("train.step", 0), ("train.forward_loss", 0), ("cycle", 4), ("obs.take", 5),
                   ("host_sync", 5), ("orphan", None)]


def test_second_thread_nests_on_its_own():
    trace.enable()
    inside = threading.Event()
    release = threading.Event()

    def worker():
        with trace.span("obs.prepare", request=2):
            inside.set()
            release.wait(10)
            with trace.span("truth"):
                pass

    with trace.span("cycle", request=1):
        t = threading.Thread(target=worker, name="obs-prefetch_0")
        t.start()
        assert inside.wait(10)
        with trace.span("solve"):
            release.set()
            t.join(10)
    assert not t.is_alive()
    by = {r["name"]: r for r in trace.records()}
    assert by["obs.prepare"]["parent"] is None and by["obs.prepare"]["thread"] == "obs-prefetch_0"
    assert by["truth"]["parent"] == by["obs.prepare"]["id"] and by["truth"]["request"] == 2
    assert by["solve"]["parent"] == by["cycle"]["id"] and by["solve"]["request"] == 1


def test_enable_drops_old_spans_and_disable_stops_new_ones():
    trace.enable()
    with trace.span("old"):
        pass
    trace.enable()
    with trace.span("open"):
        trace.disable()
        with trace.span("after"):
            pass
    assert [r["name"] for r in trace.records()] == ["open"]  # open spans still end


def test_counters_always_on_and_copied():
    before = trace.counters()
    trace.count("test.a")
    trace.enable()
    trace.count("test.a", 2)
    trace.count("test.b")
    got = trace.counters()
    got["test.a"] = -1  # a copy
    assert _diff(before) == {"test.a": 3, "test.b": 1}


def test_counters_exact_under_many_threads():
    before = trace.counters()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [trace.count("test.stress") for _ in range(500)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert _diff(before) == {"test.stress": 16 * 500}


@pytest.mark.parametrize("on_at_capture", [False, True])
def test_capture_tallies_and_each_replay_adds_the_tally(monkeypatch, on_at_capture):
    class Event:  # an external timing event: a graph records it at each replay
        def __init__(self, enable_timing=False, external=False):
            assert enable_timing and external
            made.append(self)

        def record(self):
            pass

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return end.at - self.at

    made, stream = [], threading.local()  # stream.capturing: this thread's stream captures
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(capture, "capturing", lambda: getattr(stream, "capturing", False))

    def worker():  # the obs prefetch: its own stream, not captured
        trace.count("test.worker")
        with trace.span("worker"):
            pass

    before = trace.counters()
    if on_at_capture:
        trace.enable()
    with trace.tallied() as tally:
        stream.capturing = True
        trace.count("test.body")
        with trace.span("host"), trace.span("test.step", device=True, k=1):
            trace.count("test.body", 2)
        th = threading.Thread(target=worker)
        th.start()
        th.join(30)
        assert not th.is_alive()
        stream.capturing = False
    trace.count("test.after")
    assert _diff(before) == {"test.worker": 1, "test.after": 1}
    assert tally.counts == {"test.body": 3} and len(made) == 2
    assert [r["name"] for r in trace.records()] == (["worker"] if on_at_capture else [])
    made[0].at, made[1].at = 1.0, 3.5  # one replay's events
    trace.enable()
    with trace.span("lbfgs.probe"):
        tally.replayed()
    trace.disable()
    tally.replayed()  # tracing off: the counts alone
    assert _diff(before) == {"test.worker": 1, "test.after": 1, "test.body": 6}
    recs = trace.records()
    (step,) = [r for r in recs if r["name"] == "test.step"]
    (probe,) = [r for r in recs if r["name"] == "lbfgs.probe"]
    assert step["device_ms"] == 2.5 and step["attrs"] == {"k": 1}
    assert step["parent"] == probe["id"] and probe["start_ns"] <= step["start_ns"]
    assert len(recs) == 2


def test_write_jsonl_round_trip(tmp_path):
    trace.enable()
    with trace.span("cycle", request=0):
        with trace.span("lbfgs.probe", kind="entry"):
            trace.count("test.rt")
    path = tmp_path / "spans.jsonl"
    trace.write_jsonl(path)
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    recs = trace.records()
    stamps = ("start_ns", "end_ns")  # each records() reads the clocks anew
    assert [{k: v for k, v in r.items() if k not in stamps} for r in lines[:-1]] == \
        [{k: v for k, v in r.items() if k not in stamps} for r in recs]
    for got, want in zip(lines[:-1], recs):
        assert all(abs(got[k] - want[k]) < 1000 for k in stamps)
    assert lines[-1] == {"counters": trace.counters()}


def test_exported_writes_the_file_and_none_does_nothing(tmp_path):
    with trace.exported(None):
        with trace.span("nothing"):
            pass
    assert not trace.enabled() and trace.records() == []
    path = tmp_path / "run.jsonl"
    with pytest.raises(RuntimeError):
        with trace.exported(str(path)):
            with trace.span("cycle", request=0):
                raise RuntimeError("the run failed")
    assert not trace.enabled()
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["name"] for r in lines[:-1]] == ["cycle"] and "counters" in lines[-1]


def test_clock_is_the_profilers(tmp_path):
    x = torch.randn(96, 96)
    trace.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("mm"):
            (x @ x).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    (mm,) = [e for e in doc["traceEvents"] if e.get("name") == "aten::mm"]
    (r,) = trace.records()
    start = mm["ts"] * 1e3 + doc["baseTimeNanoseconds"]
    assert r["start_ns"] <= start <= start + mm["dur"] * 1e3 <= r["end_ns"]


def _rosenbrock(x):
    return (100 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2).sum()


@pytest.mark.parametrize("linesearch", ["zoom", "jvp-zoom"])
def test_lbfgs_probe_spans_and_counters_match_the_result(linesearch):
    before = trace.counters()
    trace.enable()
    res = lbfgs_minimize(_rosenbrock, torch.full((8,), -1.2), max_iters=20,
                         linesearch=linesearch)
    recs = trace.records()
    names = Counter(r["name"] for r in recs)
    kinds = Counter(r["attrs"]["kind"] for r in recs if r["name"] == "lbfgs.probe")
    # one charged eval at entry (run, as the state holds no value yet), the
    # linesearch probes, and the uncharged restores
    probes = res.n_evals + res.n_restore
    assert names["lbfgs.probe"] == probes
    assert kinds == Counter({"entry": 1, "grad": res.n_evals - 1 - res.n_jvp, "jvp": res.n_jvp,
                             "restore": res.n_restore}) - Counter()
    assert names["lbfgs.jvp"] == res.n_jvp and names["lbfgs.direction"] == res.n_iters
    assert names["lbfgs.forward"] == names["lbfgs.backward"] == probes - res.n_jvp
    want = {"lbfgs.probes": probes, "host_syncs": names["host_sync"],
            "lbfgs.jvp": res.n_jvp, "lbfgs.restores": res.n_restore}
    assert _diff(before) == {k: v for k, v in want.items() if v}
    if linesearch == "jvp-zoom":
        assert res.n_jvp > 0 and res.n_restore > 0
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        if r["name"] in ("lbfgs.forward", "lbfgs.backward", "lbfgs.jvp"):
            assert by_id[r["parent"]]["name"] == "lbfgs.probe"


def _run_da(work, spans=None):
    from vaevar_tpu_torch import run_da

    return run_da.main(MICRO_DA + ["--work_dir", str(work)]
                       + (["--spans", str(spans)] if spans else []))


@pytest.fixture(scope="module")
def micro_da(tmp_path_factory):
    """Two micro cycles on the CPU, with --spans and without."""
    root = tmp_path_factory.mktemp("trace_da")
    before = trace.counters()
    on = _run_da(root / "on", root / "spans.jsonl")
    counted = _diff(before)
    off = _run_da(root / "off")
    lines = [json.loads(line) for line in (root / "spans.jsonl").read_text().splitlines()]
    return on, off, lines[:-1], counted


def test_run_da_spans_flag_writes_the_span_tree(micro_da):
    on, _, recs, _ = micro_da
    assert not trace.enabled()
    by_id = {r["id"]: r for r in recs}

    def parent(r):
        return by_id[r["parent"]]["name"] if r["parent"] is not None else None

    cycles = [r for r in recs if r["name"] == "cycle"]
    assert [r["request"] for r in cycles] == [0, 1] and len(on.cycle_log) == 2
    pairs = Counter((r["name"], parent(r)) for r in recs if r["request"] == 1)
    for name, up in [("obs.take", "cycle"), ("reduce", "cycle"), ("score", "cycle"),
                     ("save", "cycle"), ("advance", "cycle"), ("solve", "cycle"),
                     ("solve.segment", "solve"), ("solve.diagnostics", "solve"),
                     ("lbfgs.probe", "solve.segment"), ("lbfgs.direction", "solve.segment"),
                     ("lbfgs.forward", "lbfgs.probe"), ("lbfgs.backward", "lbfgs.probe"),
                     ("host_sync", "lbfgs.probe"), ("host_sync", "solve.diagnostics"),
                     ("obs.prepare", None)]:
        if up is None:
            assert any(n == name for n, _ in pairs), name
        else:
            assert pairs[(name, up)] > 0, (name, up)
    assert pairs[("solve.segment", "solve")] == 2 and pairs[("solve.diagnostics", "solve")] == 3
    prepare = [r for r in recs if r["name"] == "obs.prepare"]
    assert [r["request"] for r in prepare] == [0, 1]
    assert all(r["thread"].startswith("obs-prefetch") and r["parent"] is None for r in prepare)
    for r in recs:
        if r["thread"] == "MainThread":
            assert r["request"] in (0, 1), r


def test_run_da_solve_nests_in_the_cycle(micro_da):
    _, _, recs, _ = micro_da
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        if r["name"] == "solve":
            assert by_id[r["parent"]]["name"] == "cycle"
            assert by_id[r["parent"]]["request"] == r["request"]


def test_run_da_probes_are_the_evals_the_solver_ran(micro_da):
    on, _, recs, counted = micro_da
    for k, c in enumerate(on.cycle_log):
        probes = [r for r in recs if r["name"] == "lbfgs.probe" and r["request"] == k]
        # each segment charges one eval at entry; only the first runs it
        want = sum(c["n_evals"]) - len(c["n_evals"]) + sum(c["n_restore"]) + 1
        assert len(probes) == want, (k, c["n_evals"], c["n_restore"])
        assert sum(r["attrs"]["kind"] == "jvp" for r in probes) == sum(c["n_jvp"])
    assert counted["lbfgs.probes"] == sum(r["name"] == "lbfgs.probe" for r in recs)


def test_run_da_tracing_changes_no_number(micro_da):
    on, off, _, _ = micro_da
    strip = [{k: v for k, v in c.items() if k not in TIMINGS} for c in off.cycle_log]
    assert [{k: v for k, v in c.items() if k not in TIMINGS} for c in on.cycle_log] == strip
    files = sorted(p.name for p in Path(off.work_dir).glob("*.npy"))
    assert any(f.startswith("xa_") for f in files)
    for f in files:
        np.testing.assert_array_equal(np.load(Path(on.work_dir) / f, allow_pickle=True),
                                      np.load(Path(off.work_dir) / f, allow_pickle=True), f)


def _train_steps(n, tracing):
    from vaevar_tpu_torch import config as cfgs
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.train import forecast_trainer as ft

    torch.manual_seed(0)
    hw = (16, 32)
    model = LGUnet(cfgs.micro_config(img_size=hw))
    init_fn, step = ft.make_forecast_train_step(model, "Possloss", lr=1e-3, total_steps=10,
                                                out_shape=(138, *hw))
    trainable, opt_state = init_fn()
    g = torch.Generator().manual_seed(1)
    data = [torch.randn((1, 69, *hw), generator=g) for _ in range(n + 1)]
    if tracing:
        trace.enable()
    losses = []
    for i in range(n):
        trainable, opt_state, loss = step(trainable, opt_state, data[i], [data[i + 1]])
        losses.append(loss.item())
    trace.disable()
    return losses, [p.detach().clone() for p in ft.trainable_parameters(trainable)]


def test_train_step_spans_once_per_step():
    _train_steps(2, tracing=True)
    recs = trace.records()
    by_id = {r["id"]: r for r in recs}
    got = [(r["name"], r["request"]) for r in recs]
    want = []
    for i in range(2):
        want += [("train.step", i), ("train.forward_loss", i), ("train.backward", i),
                 ("train.optimizer", i)]
    assert got == want
    for r in recs:
        if r["name"] != "train.step":
            assert by_id[r["parent"]]["name"] == "train.step"
        assert r["device_ms"] is None  # no card: no device time


def test_train_step_tracing_changes_no_number():
    losses_off, params_off = _train_steps(2, tracing=False)
    losses_on, params_on = _train_steps(2, tracing=True)
    assert losses_on == losses_off
    for a, b in zip(params_on, params_off):
        assert torch.equal(a, b)


def test_run_train_forecast_spans_flag(tmp_path):
    from vaevar_tpu_torch import run_train_forecast

    path = tmp_path / "spans.jsonl"
    _, history = run_train_forecast.main(
        ["--device", "cpu", "--micro", "--grid", "32x64", "--batch_size", "1", "--steps", "2",
         "--end_time", "2022-01-03 00:00:00", "--out_dir", str(tmp_path / "out"),
         "--spans", str(path)])
    recs = [json.loads(line) for line in path.read_text().splitlines()][:-1]
    reads = [r["request"] for r in recs if r["name"] == "train.loss_read"]
    steps = [r["request"] for r in recs if r["name"] == "train.step"]
    assert reads == steps == list(range(len(history))) and len(history) == 2


@pytest.mark.gpu
def test_marker_kernel_starts_inside_the_span_that_launched_it(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.ones(1, device="cuda").add_(1)
    torch.cuda.synchronize()
    trace.enable()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda._sleep(1000)  # the tracer's own start-up
        torch.cuda.synchronize()
        for _ in range(3):
            with trace.span("launch"):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    marks = sorted((e for e in doc["traceEvents"]
                    if e.get("cat") == "kernel" and "spin_kernel" in e.get("name", "")),
                   key=lambda e: e["ts"])[-3:]
    spans = trace.records()
    assert len(marks) == len(spans) == 3
    for m, r in zip(marks, spans):
        start = m["ts"] * 1e3 + doc["baseTimeNanoseconds"]
        assert r["start_ns"] - 2e6 <= start <= r["end_ns"] + 2e6, (start - r["start_ns"],
                                                                    r["end_ns"] - start)
