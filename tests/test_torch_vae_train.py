"""The port's NMC VAE trainer against the JAX package's.

Micro configs with two variable groups (4 + 13 channels) at 16x32 in f32,
as tests/test_training.py: the forecast (NMC) model a rope micro LGUnet, the
VAE relbias micro encoder (16 channels: mu and logvar of 8) and decoder.
Weights cross over through the bridge (utils/port_jax.py); frames come from
numpy seeds. The reparameterization noise cannot be JAX's draw in torch, so
the parity tests draw JAX's eps for the step's key and hand it to the port.

Tolerances, with the reason:
- dataset starts, epoch permutations, shards and loader batches: bitwise
  (the same numpy code and draws, datetimes in place of pandas).
- nmc_error_sample: rtol 1e-4, atol 1e-6 (f32 forwards of the rolled-out
  model, as test_torch_train.py's rollout).
- the trainer's noise against jax.random: keys and bits bitwise, normals
  within 4 ulp of max(|x|, 1) (the inverse error function's log1p is
  torch's, not XLA's; observed 3).
- loss: rtol 1e-5; gradients rtol 1e-3 with atol 1e-4 x the largest
  |gradient|; parameters after 2 Adam steps atol 2.5 x lr. The reasons are
  test_torch_train.py's: f32 round-off through ~30 layers, and Adam turning
  a round-off gradient into a +-lr step.
"""

from datetime import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import model_pair, rand
from vaevar_tpu import config as C
from vaevar_tpu.data import nmc as jnmc
from vaevar_tpu.data.era5 import SyntheticEra5 as JaxEra5
from vaevar_tpu.models.vae import VAE as JaxVAE
from vaevar_tpu.train import vae_trainer as jvt
from vaevar_tpu.utils.fast_init import fast_init as jax_fast_init
from vaevar_tpu_torch.data import nmc as tnmc
from vaevar_tpu_torch.data.era5 import SyntheticEra5 as TorchEra5
from vaevar_tpu_torch.models.vae import VAE as TorchVAE
from vaevar_tpu_torch.train import checkpoint as tckpt
from vaevar_tpu_torch.train import vae_trainer as tvt
from vaevar_tpu_torch.utils.port_jax import vae_state_dict_from_flax

torch.set_num_threads(1)

HW = (16, 32)
NC = 17
LR, SIGMA, NMC = 1e-4, 2.0, 2
FC_CFG = C.micro_config(img_size=HW, inchans_list=(4, 13), outchans_list=(8, 26))
ENC = C.micro_config(img_size=HW, attn_type="relbias", inchans_list=(4, 13),
                     outchans_list=(4, 12))
DEC = ENC.replace(inchans_list=(2, 6), outchans_list=(4, 13))


@pytest.mark.parametrize("start,end,length,stride", [
    ("2022-01-01", "2022-01-05", 5, 6), ("2022-01-01 06:00:00", "2022-01-02 00:00:00", 2, 12),
    ("2022-01-01", "2022-01-01 18:00:00", 5, 6)])
def test_dataset_starts_equal_jax(start, end, length, stride):
    j = jnmc.NMCSequenceDataset(None, start, end, length=length, sample_stride_hours=stride)
    t = tnmc.NMCSequenceDataset(None, start, end, length=length, sample_stride_hours=stride)
    assert [s.to_pydatetime() for s in j.starts] == t.starts
    assert all(isinstance(s, datetime) for s in t.starts)


@pytest.mark.parametrize("n,shuffle,seed,epoch,rank,world", [
    (10, True, 0, 0, 0, 1), (10, True, 3, 2, 0, 1), (10, False, 0, 0, 0, 1),
    (7, True, 1, 1, 1, 3), (3, True, 2, 0, 5, 8), (12, True, 0, 4, 2, 4)])
def test_epoch_indices_equal_jax(n, shuffle, seed, epoch, rank, world):
    np.testing.assert_array_equal(tnmc.epoch_indices(n, shuffle, seed, epoch, rank, world),
                                  jnmc.epoch_indices(n, shuffle, seed, epoch, rank, world))


@pytest.mark.parametrize("kw", [dict(seed=1), dict(seed=2, epoch=1, drop_last=False),
                                dict(rank=1, world_size=2)])
def test_batched_loader_equals_jax(kw):
    args = ("2022-01-01", "2022-01-03")
    j = jnmc.NMCSequenceDataset(JaxEra5(hw=HW, seed=0), *args, length=3)
    t = tnmc.NMCSequenceDataset(TorchEra5(hw=HW, seed=0), *args, length=3)
    jb, tb = list(jnmc.batched_loader(j, 2, **kw)), list(tnmc.batched_loader(t, 2, **kw))
    assert len(jb) == len(tb) > 0
    for a, b in zip(jb, tb):
        assert b.dtype == np.float32 and b.shape[1:] == (3, 69, *HW)
        np.testing.assert_array_equal(b, a)


@pytest.fixture(scope="module")
def models():
    jfc, jfc_p, tfc = model_pair(FC_CFG, seed=1)
    jvae = JaxVAE(ENC, DEC)
    x = jnp.zeros((1, NC, *HW), jnp.float32)
    vae_p = jax.tree.map(np.asarray, jax_fast_init(jvae, x, jax.random.PRNGKey(0), seed=2))
    return (jfc, jfc_p, tfc.requires_grad_(False)), (jvae, vae_p)


def _port_vae(vae_p):
    vae = TorchVAE(ENC, DEC)
    vae.load_state_dict(vae_state_dict_from_flax(vae_p, ENC, DEC), strict=True)
    return vae


def test_nmc_error_sample_matches_jax(models):
    (jfc, jfc_p, tfc), _ = models
    frames = rand((2, NMC + 1, NC, *HW), 3)
    want = np.asarray(jvt.nmc_error_sample(jnp.asarray(frames), jfc.apply, jfc_p, (8, 16),
                                           nmc_steps=NMC))
    got = tvt.nmc_error_sample(torch.from_numpy(frames), tfc, (8, 16), nmc_steps=NMC)
    assert got.shape == (2, NC, 8, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)


def test_train_step_matches_jax(models):
    (jfc, jfc_p, tfc), (jvae, vae_p) = models
    batches = [rand((2, NMC + 1, NC, *HW), 10 + i) for i in range(2)]
    keys = [jax.random.PRNGKey(20 + i) for i in range(2)]

    init_fn, step = jvt.make_vae_train_step(jvae, jfc.apply, sigma=SIGMA, lr=LR,
                                            latent_hw=HW, nmc_steps=NMC)
    params, opt_state = init_fn(None, None, None, params=vae_p)
    step_j = jax.jit(step)
    j_metrics, j_states, j_grads = [], [], None
    for frames, key in zip(batches, keys):
        params, opt_state, m = step_j(params, opt_state, jfc_p, jnp.asarray(frames), key)
        j_metrics.append({k: float(v) for k, v in m.items()})
        j_states.append(vae_state_dict_from_flax(jax.tree.map(np.asarray, params), ENC, DEC))
        if j_grads is None:  # Adam's first moment after one update is (1 - b1) g
            j_grads = vae_state_dict_from_flax(
                jax.tree.map(lambda m: np.asarray(m) / np.float32(0.1), opt_state[0].mu),
                ENC, DEC)

    vae = _port_vae(vae_p)
    init_fn, step = tvt.make_vae_train_step(vae, tfc, sigma=SIGMA, lr=LR, latent_hw=HW,
                                            nmc_steps=NMC)
    opt = init_fn()
    group = opt.param_groups[0]
    assert (group["betas"], group["eps"], group["lr"]) == ((0.9, 0.999), 1e-8, LR)
    t_metrics = []
    for i, (frames, key) in enumerate(zip(batches, keys)):
        eps = np.asarray(jax.random.normal(key, (2, 8, *HW), jnp.float32))
        m = step(opt, torch.from_numpy(frames), eps=torch.from_numpy(eps.copy()))
        t_metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            t_grads = {k: p.grad.numpy().copy() for k, p in vae.named_parameters()}
            t_state1 = {k: v.numpy().copy() for k, v in vae.state_dict().items()}

    for got, want in zip(t_metrics, j_metrics):
        for k in ("loss", "rec_sse", "kld"):
            assert got[k] == pytest.approx(want[k], rel=1e-5), k
    assert sorted(t_grads) == sorted(j_grads)
    scale = max(np.abs(g.numpy()).max() for g in j_grads.values())
    for k, g in j_grads.items():
        np.testing.assert_allclose(t_grads[k], g.numpy(), rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=k)
    for got, want in ((t_state1, j_states[0]), (vae.state_dict(), j_states[1])):
        for k, v in want.items():
            np.testing.assert_allclose(np.asarray(got[k]), v.numpy(), rtol=0, atol=2.5 * LR,
                                       err_msg=k)


def _small_train(tfc, vae_p, **kw):
    batches = [rand((2, NMC + 1, NC, *HW), 30 + i) for i in range(2)]
    logs = []
    vae, hist = tvt.train_vae(_port_vae(vae_p), tfc, lambda e: iter(batches), lr=1e-3,
                              sigma=SIGMA, latent_hw=HW, nmc_steps=NMC, seed=5, log_every=1,
                              logger=logs.append, **kw)
    return vae, [h["loss"] for h in hist], logs


def test_resume_reproduces_the_loss_trajectory(models, tmp_path):
    """Stop after epoch 0's checkpoint, restart from checkpoint_latest: the
    resumed epoch repeats the uninterrupted run's losses (the per-step noise
    comes from (seed, epoch, step)), and a finished run trains nothing."""
    (_, _, tfc), (_, vae_p) = models
    vae_full, full, logs = _small_train(tfc, vae_p, epochs=2)
    assert len(full) == 4 and np.isfinite(full).all()
    assert sum("prior-sample std" in line for line in logs) == 2
    d = str(tmp_path / "ck")
    _small_train(tfc, vae_p, epochs=1, ckpt_dir=d)
    vae_res, resumed, logs = _small_train(tfc, vae_p, epochs=2, ckpt_dir=d)
    assert any(line.startswith(f"resumed from {d}/checkpoint_latest at epoch 1") for line in logs)
    np.testing.assert_allclose(resumed, full[2:], rtol=1e-6)
    for k, v in vae_full.state_dict().items():
        np.testing.assert_allclose(vae_res.state_dict()[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    assert tckpt.exists(d + "/checkpoint_latest") and tckpt.exists(d + "/checkpoint_best")
    assert _small_train(tfc, vae_p, epochs=2, ckpt_dir=d)[1] == []
    assert tvt.replicated_checksum(vae_res) > 0


@pytest.mark.parametrize("seed, keys, shape", [(0, (0, 0), (8, 8, 32, 64)), (5, (3, 2), (2, 8, 16, 32)),
                                          (123, (10_000,), (1, 32, 4, 8)), (1, (2 ** 31 + 7,), (3,))])
def test_jax_random_replays_jax(seed, keys, shape):
    """The trainer's noise (utils/jax_random.py) against jax.random: keys and
    uniform bits bitwise; normals within 4 ulp of max(|x|, 1) (XLA's erfinv
    polynomial, with torch's log1p in place of XLA's; observed 3)."""
    from vaevar_tpu_torch.utils import jax_random as tjr

    kj, kt = jax.random.PRNGKey(seed), tjr.prng_key(seed)
    for k in keys:
        kj, kt = jax.random.fold_in(kj, k), tjr.fold_in(kt, k)
    assert tuple(int(v) for v in np.asarray(kj)) == kt
    np.testing.assert_array_equal(tjr._bits(kt, shape, "cpu").numpy().astype(np.uint32),
                                  np.asarray(jax.random.bits(kj, shape, jnp.uint32)))
    want = np.asarray(jax.random.normal(kj, shape, jnp.float32))
    got = tjr.normal(kt, shape).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    assert (np.abs(got - want) <= 4 * np.spacing(np.maximum(np.abs(want), 1))).all()


@pytest.mark.parametrize("shape, rows", [((4, 8, 16, 32), (2, 3)), ((6, 3), (0, 2)),
                                         ((5, 7, 2), (3, 5))])
def test_jax_random_rows_equal_the_whole_draw(shape, rows):
    """A data-parallel rank's rows of the global noise (`rows=`) equal the
    same rows of jax.random's whole draw: bits bitwise, normals within 4 ulp
    of max(|x|, 1), and bitwise the port's whole draw's rows."""
    from vaevar_tpu_torch.utils import jax_random as tjr

    kj, kt = jax.random.fold_in(jax.random.PRNGKey(7), 2), tjr.fold_in(tjr.prng_key(7), 2)
    lo, hi = rows
    np.testing.assert_array_equal(
        tjr._bits(kt, shape, "cpu", rows).numpy().astype(np.uint32),
        np.asarray(jax.random.bits(kj, shape, jnp.uint32))[lo:hi])
    got = tjr.normal(kt, shape, rows=rows).numpy()
    want = np.asarray(jax.random.normal(kj, shape, jnp.float32))[lo:hi]
    assert got.shape == (hi - lo, *shape[1:])
    assert (np.abs(got - want) <= 4 * np.spacing(np.maximum(np.abs(want), 1))).all()
    np.testing.assert_array_equal(got, tjr.normal(kt, shape).numpy()[lo:hi])


def test_probe_refuses_a_wrong_batch(models):
    (_, _, tfc), (_, vae_p) = models
    with pytest.raises(ValueError, match="empty training loader"):
        tvt.train_vae(_port_vae(vae_p), tfc, [], latent_hw=HW, nmc_steps=NMC)
    with pytest.raises(ValueError, match="nmc_steps"):
        tvt.train_vae(_port_vae(vae_p), tfc, [rand((2, NMC, NC, *HW), 1)], latent_hw=HW,
                      nmc_steps=NMC)


CLI = ["--device", "cpu", "--micro", "--fast_init", "--grid", "32x64", "--batch_size", "2",
       "--end_time", "2022-01-03 00:00:00", "--no-bf16"]


def test_cli_trains_resumes_and_run_da_reads_vae_latest(tmp_path):
    from vaevar_tpu_torch import run_da, run_train_vae

    out = str(tmp_path / "vae")
    _, first = run_train_vae.main(CLI + ["--epochs", "1", "--out_dir", out])
    _, second = run_train_vae.main(CLI + ["--epochs", "2", "--out_dir", out])
    assert len(first) == len(second) == 2
    assert np.isfinite([h["loss"] for h in first + second]).all()
    with open(out + "/run.log") as f:
        assert "resumed from" in f.read()
    saved = tckpt.restore(out + "/vae_latest")
    assert any(k.startswith("enc.") for k in saved) and any(k.startswith("dec.") for k in saved)
    # --vae_ckpt warm-starts the whole VAE strictly: with no epoch to train,
    # the new vae_latest is the file it started from
    warm = str(tmp_path / "warm")
    run_train_vae.main(CLI + ["--epochs", "0", "--vae_ckpt", out + "/vae_latest", "--out_dir",
                              warm])
    again = tckpt.restore(warm + "/vae_latest")
    assert sorted(again) == sorted(saved) and all(torch.equal(again[k], saved[k]) for k in saved)
    da = run_da.main(["--device", "cpu", "--micro", "--fast_init", "--no-bf16", "--grid",
                      "32x64", "--solver_grid", "32x64", "--init_lag", "1", "--Nit", "1",
                      "--end_time", "2022-01-01 06:00:00", "--vae_ckpt", out + "/vae_latest",
                      "--work_dir", str(tmp_path / "da")])
    dec = {k[len("dec."):]: v for k, v in saved.items() if k.startswith("dec.")}
    for k, v in da.decoder.state_dict().items():
        assert torch.equal(v, dec[k]), k
    assert da.cfg.latent_shape == (1, 32, 32, 64)
    assert len(da.cycle_log) == 1 and da.cycle_log[0]["xa_finite"]


def test_cli_needs_a_card_or_device_cpu(tmp_path):
    from vaevar_tpu_torch import run_train_vae

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(SystemExit, match="--device cpu"):
        run_train_vae.main(["--micro", "--out_dir", str(tmp_path)])
    # --mesh 2 (or 2x1x1, the same mesh) outside a 2-process launch never
    # trains dp=1
    with pytest.raises(RuntimeError, match="needs 2 processes"):
        run_train_vae.main(["--device", "cpu", "--mesh", "2"])
    with pytest.raises(RuntimeError, match="needs 2 processes"):
        run_train_vae.main(["--device", "cpu", "--mesh", "2x1x1"])
