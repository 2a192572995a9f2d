"""Scalar event logging: the port of vaevar_tpu/utils/meters.py's
`ScalarWriter` (the reference's TensorBoard `SummaryWriter` use,
model/model.py:455-457), an append-only JSONL scalar log (one JSON object
per line, {"tag", "value", "step", "wall_time"}; load with
`pandas.read_json(path, lines=True)`).
"""

from __future__ import annotations

import json
import os
import time


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
