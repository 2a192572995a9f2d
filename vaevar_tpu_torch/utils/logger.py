"""Rank-aware logging, phase timers and device traces: the port of
vaevar_tpu/utils/logger.py (the reference's utils/logger.py:8-37 and its
wall-clock instrumentation, da_4dvar.py:759,803-804,1174-1175).
`device_trace` records with torch.profiler where JAX's records with
jax.profiler, and writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time


def get_logger(name: str, run_dir: str | None = None, rank: int = 0,
               filename: str = "run.log") -> logging.Logger:
    """A logger writing to stderr and, on rank 0 with a run_dir, to
    run_dir/filename. A second call with the same name returns the first
    logger as it was configured."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO if rank == 0 else logging.WARNING)
    logger.propagate = False  # avoid duplicate lines via the root logger
    fmt = logging.Formatter("[%(asctime)s %(name)s %(levelname)s] %(message)s", "%H:%M:%S")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if run_dir and rank == 0:
        os.makedirs(run_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(run_dir, filename))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class PhaseTimer:
    """Accumulates wall-clock per named phase; .report() prints a summary."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for k in sorted(self.totals):
            n = self.counts[k]
            lines.append(
                f"{k}: total {self.totals[k]:.2f}s x{n} "
                f"(avg {self.totals[k] / n:.3f}s)"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """torch.profiler trace context (no-op when log_dir is None): records
    the host's operators and, with a card present, its kernels and copies,
    and writes them as a Chrome trace `trace_<time>_<pid>.json` into
    log_dir when the block ends."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}.json"))
