"""NMC training batches: sequences of normalized 6-hourly frames.

Port of vaevar_tpu/data/nmc.py (numpy), with `datetime` where the JAX
package uses pandas: each sample is `length` frames spaced
`file_stride_hours` apart from a state source, normalized per channel, the
(B, length, 69, H, W) batches the VAE trainer consumes. The sample starts,
the per-epoch permutation and the per-rank shards equal the JAX package's
(tests/test_torch_vae_train.py holds them bit for bit).
"""

from __future__ import annotations

from datetime import datetime, timedelta
from typing import Iterator

import numpy as np

from vaevar_tpu_torch import channels


def _time(ts) -> datetime:
    return ts if isinstance(ts, datetime) else datetime.fromisoformat(str(ts))


class NMCSequenceDataset:
    def __init__(
        self,
        source,
        start_time,
        end_time,
        length: int = 5,
        file_stride_hours: int = 6,
        sample_stride_hours: int = 6,
    ):
        self.source = source
        self.length = length
        self.stride = timedelta(hours=file_stride_hours)
        t0, t1 = _time(start_time), _time(end_time)
        last_start = t1 - (length - 1) * self.stride
        step = timedelta(hours=sample_stride_hours)
        # pd.date_range(t0, last_start, freq=step): both ends included
        n = (last_start - t0) // step + 1 if last_start >= t0 else 0
        self.starts = [t0 + i * step for i in range(n)]

    def __len__(self):
        return len(self.starts)

    def __getitem__(self, idx: int) -> np.ndarray:
        t = self.starts[idx]
        frames = [channels.normalize(self.source.get_state(t + i * self.stride))
                  for i in range(self.length)]
        return np.stack(frames).astype(np.float32)  # (length, 69, H, W)


def epoch_indices(
    n: int, shuffle: bool = True, seed: int = 0, epoch: int = 0,
    rank: int = 0, world_size: int = 1,
) -> np.ndarray:
    """DistributedSampler analogue: one global permutation per epoch (seed +
    epoch, so every epoch reshuffles and all ranks agree), padded by cyclic
    repetition to a multiple of world_size, then stride-sliced so each
    process sees a disjoint 1/world_size of the samples."""
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(idx)
    if world_size > 1:
        total = -(-n // world_size) * world_size
        if total > n:
            idx = np.resize(idx, total)
        idx = idx[rank::world_size]
    return idx


def batched_loader(
    dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
    drop_last: bool = True, epoch: int = 0, rank: int = 0,
    world_size: int = 1,
) -> Iterator[np.ndarray]:
    """Streams per-process batches; never materializes the epoch. `epoch`
    reshuffles, rank/world_size shard the sample stream across processes."""
    idx = epoch_indices(len(dataset), shuffle, seed, epoch, rank, world_size)
    n_full = len(idx) // batch_size
    end = n_full * batch_size if drop_last else len(idx)
    for s in range(0, end, batch_size):
        chunk = idx[s : s + batch_size]
        yield np.stack([dataset[int(i)] for i in chunk])
