"""The metric arithmetic: the frozen roofline bound, the model-FLOP count,
the busy union, and the reading of a device trace."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import pb_micro
import harness
from devtrace import breakdown, flash_launches, read_events
from metrics import _busy, _flops, _roofline
from reference import lgunet as ref_lgunet

PROD = (1, 6, 16200, 192)


@pytest.mark.parametrize("qk, v, fwd, pair", [("f32", "bf16", 1.833, 8.551),
                                              ("bf16", "bf16", 1.223, 4.280)])
def test_bound_reproduces_the_kernel_table(qk, v, fwd, pair):
    b = _roofline.flash_bounds(PROD, qk, v)
    assert round(b["fwd"], 3) == fwd
    assert round(b["pair"], 3) == pair
    assert b["pair"] == b["dq"] + b["dkv"]
    assert _roofline.bound_ms(PROD, ["bf16"], 0)[1] == "operations"


@pytest.mark.parametrize("which", ["decoder", "forecast", "train"])
def test_flop_count_equals_flop_counter_on_the_reference(which):
    entry = (pb_micro.micro_train_config()["model"] if which == "train"
             else pb_micro.micro_da_config()["models"][which])
    with torch.device("meta"):
        model = ref_lgunet.LGUnet(entry)
        x = torch.empty(2, sum(entry["inchans_list"]), *entry["img_size"])
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(x)
    assert _flops.lgunet_forward_flops(entry, batch=2) == counter.get_total_flops()


def test_flop_count_at_published_widths():
    """FORECAST_025's forward: the 12 LG blocks' layers 6.19 TFLOP, the 4
    full-grid attentions 4.84, each of the encoder's and decoder's three
    levels ~1.4 over the six groups: ~16.1 TFLOP."""
    entry = harness.config_file("forecast_025")["model"]
    assert 15.5e12 < _flops.lgunet_forward_flops(entry) < 16.5e12


def test_overlapping_intervals_count_once():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 41)]
    assert _busy.busy(iv) == 26
    assert _busy.busy(iv, 8, 22) == 9
    assert _busy.gaps(iv, 0, 45) == [(15, 20), (30, 40), (41, 45)]


def _kernel(name, ts, dur, stream=7):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"stream": stream}}


def test_trace_reading_labels_gaps_by_span():
    fwd = "void (anonymous namespace)::flash_fwd_kernel<float, __nv_bfloat16, 192>(float const*)"
    events = [
        _kernel("spin_kernel(long)", 0, 1),
        _kernel("gemm", 1, 9),
        _kernel(fwd, 30, 10),  # after a gap of 20 in span "solve"
        _kernel("spin_kernel(long)", 40, 1),
        _kernel("copy", 50, 20, stream=9),  # another stream, after a gap of 9
        _kernel("gemm", 60, 20),  # overlaps the copy: counted once
        _kernel("spin_kernel(long)", 100, 1),
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0, "dur": 99},
    ]
    r = read_events(events, ["solve", "advance", "end"])
    assert r["window_s"] == pytest.approx(101e-6)
    assert r["busy_s"] == pytest.approx((9 + 10 + 30) * 1e-6)
    assert r["gaps"][0] == ("advance", pytest.approx(21e-6))  # up to the end marker's end
    assert r["gaps"][1] == ("solve", pytest.approx(20e-6))
    assert ("other stream", pytest.approx(10e-6)) in r["gaps"]
    assert flash_launches(r["kernels"])["fwd"] == (1, pytest.approx(10e-6), ("f32", "bf16"))
    b = breakdown(r)
    assert b["device_ops"][0][0] == "gemm"
    assert b["idle_gaps"][0][0] == "advance: 1 gaps"
    assert len(b["idle_gaps"]) <= 10 and len(b["device_ops"]) <= 10


def test_trace_reading_of_lost_markers():
    """Records that stopped early (the end marker lost) are read up to the
    last one; a trace without markers is refused."""
    r = read_events([_kernel("spin_kernel", 0, 1), _kernel("gemm", 3, 2)], ["solve", "end"])
    assert r["markers_lost"] == 1
    assert r["window_s"] == pytest.approx(5e-6) and r["busy_s"] == pytest.approx(2e-6)
    with pytest.raises(RuntimeError):
        read_events([_kernel("gemm", 0, 1)], ["solve", "end"])
