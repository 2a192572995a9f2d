"""A profiled sub-window of a run, read from the device trace.

`DeviceTrace.start()` synchronises and starts torch.profiler on the card
alone (no host operators, which would multiply the trace); `mark(label)`
queues a tiny marker kernel (`torch.cuda._sleep`, ATen's `spin_kernel`) on
the current stream and names the span that starts there; `stop()` marks the
end, synchronises, stops the profiler, writes the Chrome trace under the
given directory and reads it back:

- the window runs from the first marker's start to the last marker's end
  on the device's clock;
- busy time is the union of every kernel, copy and fill interval on any
  stream within it (metrics/_busy.py), so overlapping streams count once;
- each idle gap is labelled by the span in which the host launched the
  work that ends it: the span between the markers around that kernel on
  the marked stream, or "other stream" for work on another stream (the obs
  prefetch's);
- kernel device time is summed by name.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import sys
from pathlib import Path

import torch

from metrics import _busy

_ACTIVITY = ("kernel", "gpu_memcpy", "gpu_memset")
_MARKER = "spin_kernel"
_MARKER_CYCLES = 1000
# CUPTI's activity buffers: kineto's default of 128 MB fills within one DA
# cycle (~130 k kernels and their launches) and drops what follows
_KINETO = "\nACTIVITIES_MAX_GPU_BUFFER_SIZE_MB=2048"


def _profiler():
    """torch.profiler on the card alone, with room for a whole cycle's
    activity records (the setting rides in kineto's config string)."""
    from torch._C._profiler import _ExperimentalConfig

    config = _ExperimentalConfig(custom_profiler_config=_KINETO)
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                  experimental_config=config)


class DeviceTrace:
    def __init__(self, out_dir):
        self.out_dir = Path(out_dir)
        self.labels: list[str] = []
        self.prof = None
        self.result = None

    def start(self, label: str):
        torch.cuda.synchronize()
        self.prof = _profiler()
        self.prof.start()
        # the tracer's own start-up on its first launch stays out of the window
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        self.mark(label)

    def mark(self, label: str):
        if self.prof is None:
            return
        torch.cuda._sleep(_MARKER_CYCLES)
        self.labels.append(label)

    def stop(self):
        self.mark("end")
        torch.cuda.synchronize()
        self.prof.stop()
        self.out_dir.mkdir(parents=True, exist_ok=True)
        path = self.out_dir / "device_trace.json"
        self.prof.export_chrome_trace(str(path))
        self.prof = None
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(path)
        self.result = read_events(events, self.labels)
        return self.result


def _stream(ev):
    args = ev.get("args") or {}
    return args.get("stream", ev.get("tid"))


def read_events(events, labels):
    """The trace's reading: {"window_s", "busy_s", "kernels": {name: [count,
    seconds]}, "gaps": [(label, seconds)] longest first, "markers_lost"}."""
    acts = [e for e in events if e.get("ph") == "X" and e.get("cat") in _ACTIVITY]
    acts.sort(key=lambda e: e["ts"])
    marks = [e for e in acts if e.get("cat") == "kernel" and _MARKER in e.get("name", "")]
    if not marks or len(marks) > len(labels):
        raise RuntimeError(f"device trace holds {len(marks)} markers; {len(labels)} were queued")
    lost = len(labels) - len(marks)
    lo, hi = marks[0]["ts"], marks[-1]["ts"] + marks[-1]["dur"]
    if lost:  # the records stopped early: read the part the trace holds
        hi = max(hi, max(e["ts"] + e["dur"] for e in acts))
        print(f"portbench: the device trace lost its last {lost} of {len(labels)} markers; "
              "reading the part it holds", file=sys.stderr, flush=True)
    stream = _stream(marks[0])
    work = [e for e in acts if _MARKER not in e.get("name", "")]
    intervals = [(e["ts"], e["ts"] + e["dur"]) for e in work]
    kernels = {}
    for e in work:
        if lo <= e["ts"] < hi:
            k = kernels.setdefault(e["name"], [0, 0.0])
            k[0] += 1
            k[1] += e["dur"] * 1e-6
    starts = [e["ts"] for e in work]
    mark_ts = [m["ts"] for m in marks]
    gaps = []
    for s, t in _busy.gaps(intervals, lo, hi):
        i = bisect.bisect_left(starts, t)
        if i < len(work) and _stream(work[i]) != stream:
            label = "other stream"
        else:
            # the span the work after the gap was launched in; a gap that
            # ends at a marker belongs to the span before it ("end" is none)
            label = labels[min(max(bisect.bisect_left(mark_ts, t) - 1, 0), len(labels) - 2)]
        gaps.append((label, (t - s) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return {"window_s": (hi - lo) * 1e-6, "busy_s": _busy.busy(intervals, lo, hi) * 1e-6,
            "kernels": kernels, "gaps": gaps, "markers_lost": lost}


_FLASH = re.compile(r"flash_(fwd|dq|dkv)_kernel<([\w: ]+), ([\w: ]+), (\d+)>")
_TYPES = {"float": "f32", "__nv_bfloat16": "bf16"}


def flash_launches(kernels) -> dict:
    """{"fwd" | "dq" | "dkv": (launches, seconds, (q/k type, v type))} of
    the flash kernels in a trace reading's `kernels`."""
    out = {}
    for name, (n, secs) in kernels.items():
        m = _FLASH.search(name)
        if m is None:
            continue
        types = (_TYPES.get(m.group(2).strip()), _TYPES.get(m.group(3).strip()))
        c, s, t = out.get(m.group(1), (0, 0.0, types))
        out[m.group(1)] = (c + n, s + secs, t)
    return out


def breakdown(reading, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by the
    span the host was in: each span's total ("<span>: N gaps"), then the
    longest single gaps ("<span>: one gap"), at most `top` in all."""
    ops = sorted(reading["kernels"].items(), key=lambda kv: -kv[1][1])[:top]
    totals = {}
    for label, secs in reading["gaps"]:
        n, s = totals.get(label, (0, 0.0))
        totals[label] = (n + 1, s + secs)
    idle = [[f"{label}: {n} gaps", s] for label, (n, s) in
            sorted(totals.items(), key=lambda kv: -kv[1][1])]
    idle += [[f"{label}: one gap", secs] for label, secs in reading["gaps"]]
    return {"device_ops": [[_short(name), secs] for name, (_, secs) in ops],
            "idle_gaps": idle[:top]}


def _short(name: str, width: int = 120) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."
