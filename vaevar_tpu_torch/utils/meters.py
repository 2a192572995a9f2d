"""Training meters and scalar event logging: the port of
vaevar_tpu/utils/meters.py (the reference's `SmoothedValue` / `MetricLogger`,
utils/misc.py:14-183, and its TensorBoard `SummaryWriter` use,
model/model.py:455-457): windowed and global averages with a cross-process
reduction, an iteration logger with data and step timing, and an
append-only JSONL scalar log (one JSON object per line, {"tag", "value",
"step", "wall_time"}; load with `pandas.read_json(path, lines=True)`).

Cross-process sync: `synchronize_between_processes` all-reduces count and
total over the default torch.distributed group when one is up, as the
reference does over NCCL (utils/misc.py:33-45; JAX's `process_allgather`);
with no group, or a group of one, it is a no-op.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict, deque


class SmoothedValue:
    """Track a series; expose windowed median/avg and global avg
    (utils/misc.py:14-72)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self):
        """Sum count and total over the processes (float64, on the card
        under nccl, on the host otherwise); the window stays local."""
        import torch
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
            return
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
        t = torch.tensor([self.count, self.total], dtype=torch.float64, device=device)
        dist.all_reduce(t)
        self.count = int(t[0].item())
        self.total = float(t[1].item())

    @property
    def median(self) -> float:
        s = sorted(self.deque)
        return s[len(s) // 2] if s else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


class MetricLogger:
    """Iteration logger with meters + timing (utils/misc.py:96-183)."""

    def __init__(self, delimiter: str = "  ", logger=None):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self._log = logger.info if logger is not None else print

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def synchronize_between_processes(self):
        for m in self.meters.values():
            m.synchronize_between_processes()

    def add_meter(self, name, meter):
        self.meters[name] = meter

    def log_every(self, iterable, print_freq: int, header: str = ""):
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        try:
            total = len(iterable)
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                meters = self.delimiter.join(
                    f"{name}: {meter}" for name, meter in self.meters.items()
                )
                pos = f"[{i}/{total}]" if total is not None else f"[{i}]"
                self._log(
                    self.delimiter.join(
                        [header, pos, meters,
                         f"time: {iter_time}", f"data: {data_time}"]
                    )
                )
            i += 1
            end = time.time()
        self._log(f"{header} done in {time.time() - start:.1f}s")


class ScalarWriter:
    """Append-only JSONL scalar event log (SummaryWriter analogue)."""

    def __init__(self, log_dir: str, filename: str = "scalars.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self._path = os.path.join(log_dir, filename)
        self._f = open(self._path, "a", buffering=1)

    def add_scalar(self, tag: str, value, step: int):
        self._f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                  "wall_time": time.time()}) + "\n")

    def add_scalars(self, scalars: dict, step: int):
        for tag, v in scalars.items():
            self.add_scalar(tag, v, step)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
