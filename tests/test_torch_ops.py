"""Port primitives against the JAX functions on numpy-seeded inputs.

Windowing, shifts and nearest resize move values without arithmetic, and
rope and dense attention do a handful of f32 operations, so the tolerance is
1e-6 (f32 round-off of O(1) values)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import rand
from vaevar_tpu.ops import attention as jatt
from vaevar_tpu.ops import interp as jinterp
from vaevar_tpu.ops import rope as jrope
from vaevar_tpu.ops import windows as jwin
from vaevar_tpu_torch.ops import attention as tatt
from vaevar_tpu_torch.ops import interp as tinterp
from vaevar_tpu_torch.ops import rope as trope
from vaevar_tpu_torch.ops import windows as twin

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("win", [(4, 4), (6, 12), (2, 8)])
def test_window_partition_reverse_shift(win):
    x = rand((2, 12, 24, 5), 0)
    xw_j = jwin.window_partition(jnp.asarray(x), win)
    xw_t = twin.window_partition(torch.from_numpy(x), win)
    np.testing.assert_array_equal(xw_t.numpy(), np.asarray(xw_j))
    back = twin.window_reverse(xw_t, win, 12, 24)
    np.testing.assert_array_equal(back.numpy(), x)
    sh = (-(win[0] // 2), -(win[1] // 2))
    np.testing.assert_array_equal(
        twin.shift2d(torch.from_numpy(x), *sh).numpy(),
        np.asarray(jwin.shift2d(jnp.asarray(x), *sh)))


@pytest.mark.parametrize("neg", [-100.0, -np.inf])
@pytest.mark.parametrize("H,W,win,shift", [
    (8, 16, (4, 4), (2, 2)), (12, 24, (6, 12), (3, 6)),
    (8, 16, (4, 4), (0, 0)), (8, 16, (4, 16), (2, 8))])
def test_swin_attention_mask(H, W, win, shift, neg):
    mj = jwin.swin_attention_mask(H, W, win, shift, neg=neg)
    mt = twin.swin_attention_mask(H, W, win, shift, neg=neg)
    if mj is None:
        assert mt is None
    else:
        np.testing.assert_array_equal(mt, mj)
        assert mt.dtype == np.float32 and (mt == neg).any()


@pytest.mark.parametrize("win,hd", [((4, 4), 8), ((6, 12), 192), ((3, 5), 12)])
def test_apply_rope2(win, hd):
    tj = jrope.rope2_tables(win, hd)
    tt = trope.rope2_tables(win, hd)
    for a, b in zip(tt, tj):
        np.testing.assert_array_equal(a, b)
    x = rand((2, 3, win[0] * win[1], hd), 1)
    out_j = jrope.apply_rope2(jnp.asarray(x), tj)
    out_t = trope.apply_rope2(torch.from_numpy(x), [torch.from_numpy(t) for t in tt])
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


@pytest.mark.parametrize("out_hw", [(721, 1440), (64, 128), (13, 29), (16, 32)])
def test_resize_nearest(out_hw):
    x = rand((3, 16, 32), 2)
    np.testing.assert_array_equal(
        tinterp.resize_nearest(torch.from_numpy(x), out_hw).numpy(),
        np.asarray(jinterp.resize_nearest(jnp.asarray(x), out_hw)))


@pytest.mark.parametrize("masked", [False, True])
def test_dense_attention(masked):
    q, k, v = (rand((8, 2, 16, 8), 3 + i) for i in range(3))
    mask = jwin.swin_attention_mask(8, 16, (4, 4), (2, 2), neg=-100.0) if masked else None
    out_j = jatt.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 None if mask is None else jnp.asarray(mask))
    out_t = tatt.dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


def test_window_attention_core_dispatch(monkeypatch):
    """Unmasked windows of >= flash_min_seq tokens take the flash path."""
    from vaevar_tpu_torch.ops import attention

    calls = []
    monkeypatch.setattr(attention, "flash_attention",
                        lambda q, k, v: calls.append(q.shape[2]) or q)
    q = torch.zeros(1, 1, 32, 8)
    mask = torch.zeros(1, 32, 32)
    attention.window_attention_core(q, q, q, None, flash_min_seq=16)
    attention.window_attention_core(q, q, q, mask, flash_min_seq=16)
    attention.window_attention_core(q, q, q, None, flash_min_seq=64)
    assert calls == [32]
