"""CUDA graph capture as the port's code sees it (da/graphs.py captures).

- `capturing()`: whether this thread's current CUDA stream is capturing a
  graph. A backward captured on the card runs on the autograd engine's
  device thread, whose current stream is then the capturing one, so this
  holds there too; another thread's work on its own stream (the cycler's
  obs prefetch) is not captured and reads False.
- `checkpoint(fn, *args)`: torch.utils.checkpoint, non-reentrant, for the
  port's activation checkpoints (LGUnet's block remat, the window cost's
  step checkpoint). Eagerly it is torch's call as is. While capturing it
  keeps no RNG state: the stash reads the CUDA generator's state, which a
  capture does not allow, and no network of the port draws a random
  number in its forward (no dropout, no drop-path), so the recompute needs
  none.
- `device_tables(make)`: the constant tables a call needs on a device,
  made by `make` once per key (the device among it), so that no later call
  copies from the host, which a capture cannot do: the graphs' warm-up
  makes them, and one first asked for inside a capture raises.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils import checkpoint as _torch_checkpoint


def capturing() -> bool:
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def checkpoint(fn: Callable, *args):
    if capturing():
        return _torch_checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                            preserve_rng_state=False)
    return _torch_checkpoint.checkpoint(fn, *args, use_reentrant=False)


def device_tables(make: Callable) -> Callable:
    made = {}

    def tables(*key):
        if key not in made:
            if capturing():
                raise RuntimeError(f"{make.__qualname__}{key}: a table would cross "
                                   "from the host inside a CUDA graph capture")
            made[key] = make(*key)
        return made[key]

    return tables
