"""Rank-aware logging: the port of vaevar_tpu/utils/logger.py's
`get_logger` (the reference's utils/logger.py:8-37). The port's spans and
counters are utils/trace.py's.
"""

from __future__ import annotations

import logging
import os


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
