"""Classical control-variable transform (B^1/2) for sc4dvar.

Port of vaevar_tpu/da/cvt.py (the reference `cyclic_4dvar.transform`,
da_4dvar.py:878-931): control u (69, 128, 256) -> analysis increment added
to the background on the 721x1440 grid. Steps:

1. per-channel isotropic spherical smoothing via the SHT with a Gaussian
   latitude-profile kernel (da_4dvar.py:883-888), scaled 11/len_scale^2;
2. streamfunction regression coupling: every channel gains
   sum_k psi_k * reg_coeff[ch, k] with psi the u-wind block (or the z and u
   blocks when reg_coeff has 26 rows) (da_4dvar.py:890-897);
3. surface std scaling of the 4 surface channels (da_4dvar.py:901);
4. per-variable vertical EOF projection V diag(sqrt(lambda))
   (da_4dvar.py:903-906);
5. psi/chi -> (u, v) winds by spherical finite differences with the
   reference's stencils and signs (da_4dvar.py:908-926);
6. nearest upsample to the analysis grid, plus xb (da_4dvar.py:928).

The tables live on the transform's device as f32 tensors; the transform is
linear and runs under reverse- and forward-mode AD.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from vaevar_tpu_torch import channels
from vaevar_tpu_torch.channels import N_LEVELS, N_SINGLE
from vaevar_tpu_torch.ops.interp import resize_nearest
from vaevar_tpu_torch.ops.sht import SHT, gaussian_lat_kernel

_EARTH_M_PER_DEG = 111195.0


@dataclass(frozen=True)
class BMatrixAssets:
    """Static B-matrix coefficient arrays (reference dataset/bq_info_lr)."""

    len_scale: np.ndarray  # (69,), already multiplied by scale_factor
    reg_coeff: np.ndarray  # (69, 13) or (69, 26)
    std_sur: np.ndarray  # (4,)
    vert_eig_value: np.ndarray  # (5, 13)
    vert_eig_vec: np.ndarray  # (5, 13, 13)

    @classmethod
    def load(cls, coeff_dir: str, scale_factor: float = 1.0) -> "BMatrixAssets":
        def ld(n):
            return np.load(os.path.join(coeff_dir, n)).astype(np.float32)

        return cls(
            len_scale=ld("len_scale.npy") * scale_factor,
            reg_coeff=ld("reg_coeff.npy"),
            std_sur=ld("std_sur.npy"),
            vert_eig_value=ld("vert_eig_value.npy"),
            vert_eig_vec=ld("vert_eig_vec.npy"),
        )

    @classmethod
    def synthetic(cls, scale_factor: float = 1.0, seed: int = 0,
                  calibrate: bool = True, device="cpu") -> "BMatrixAssets":
        """Plausible stand-in assets for runs without the .npy files.

        The numpy draws are the JAX package's. With `calibrate` (default),
        the per-block output scales are fitted so that B^1/2 of a unit-normal
        control has per-channel std near the NMC background-error magnitude
        ERR_STD*STD, the scale the reference's real assets have by
        construction; uncalibrated random tables leave the wind channels
        ~1e5 too weak and the humidity channels relatively huge, a quadratic
        no optimizer can move. Calibration runs this port's increment on two
        controls on `device`, once per (scale_factor, seed), at 128x256."""
        key = (float(scale_factor), int(seed))
        if calibrate and key in _SYNTH_CACHE:
            return _SYNTH_CACHE[key]
        rng = np.random.default_rng(seed)
        q = rng.normal(size=(5, 13, 13))
        vecs = np.stack([np.linalg.qr(m)[0] for m in q]).astype(np.float32)
        vals = np.exp(rng.normal(size=(5, 13))).astype(np.float32)
        raw = cls(
            len_scale=(1.0 + 3.0 * rng.random(69).astype(np.float32)) * scale_factor,
            reg_coeff=(0.1 * rng.normal(size=(69, 13))).astype(np.float32),
            std_sur=np.ones(4, np.float32),
            vert_eig_value=vals,
            vert_eig_vec=vecs,
        )
        if not calibrate:
            return raw
        probe_t = CVTransform(raw, solver_hw=(128, 256), out_hw=(128, 256), device=device)
        u = torch.as_tensor(rng.normal(size=(2, 69, 128, 256)), dtype=torch.float32,
                            device=device)
        with torch.no_grad():
            got = torch.stack([probe_t.increment(ui) for ui in u]).cpu().numpy().std(
                axis=(0, 2, 3))
        got = np.maximum(got, 1e-30)
        target = (channels.ERR_STD * channels.STD).astype(np.float64)
        r = target / got
        nl, ns = N_LEVELS, N_SINGLE
        # output channel l of block i scales with ROW l of its EOF matrix;
        # level-l winds come from psi_l and chi_l jointly, so blocks 2 and 3
        # share one per-level factor, the geometric mean of the u_l and v_l
        # ratios
        vecs_cal = raw.vert_eig_vec.astype(np.float64).copy()
        for i in (0, 1, 4):
            vecs_cal[i] *= r[ns + i * nl : ns + (i + 1) * nl, None]
        g_lvl = np.sqrt(r[ns + 2 * nl : ns + 3 * nl] * r[ns + 3 * nl : ns + 4 * nl])
        vecs_cal[2] *= g_lvl[:, None]
        vecs_cal[3] *= g_lvl[:, None]
        out = cls(
            len_scale=raw.len_scale,
            reg_coeff=raw.reg_coeff,
            # surface channels scale directly through std_sur
            std_sur=(target[:ns] / got[:ns]).astype(np.float32),
            vert_eig_value=raw.vert_eig_value,
            vert_eig_vec=vecs_cal.astype(np.float32),
        )
        _SYNTH_CACHE[key] = out
        return out


_SYNTH_CACHE: dict = {}


class CVTransform:
    """Callable B^1/2: (u, xb) -> xb + increment on `out_hw`."""

    def __init__(
        self,
        b: BMatrixAssets,
        solver_hw: tuple[int, int] = (128, 256),
        out_hw: tuple[int, int] = (721, 1440),
        hpad: int = 112,
        device="cpu",
    ):
        self.b = b
        self.out_hw = out_hw
        nlat, nlon = solver_hw
        self.nlat, self.nlon = nlat, nlon
        self.sht = SHT(nlat, nlon, device=device)
        kern = gaussian_lat_kernel(hpad, nlat, b.len_scale, device)  # (69, nlat)
        self.kernel_l0 = self.sht.zonal_coeffs(kern)  # (69, lmax)
        self.psi_wide = b.reg_coeff.shape[1] != N_LEVELS

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)

        self._len_scale = t(b.len_scale).reshape(-1, 1, 1)
        self._reg = t(b.reg_coeff)
        self._std_sur = t(b.std_sur).reshape(-1, 1, 1)
        # V diag(sqrt(lambda)) per multi-level variable
        self._eof = t(b.vert_eig_vec) * torch.sqrt(t(b.vert_eig_value))[:, None, :]
        # the reference's f32 linspace of colatitudes, evaluated in f64
        self._x_scaling = t(np.sin(np.linspace(1.0 / 180.0 * np.pi, 179.0 / 180.0 * np.pi,
                                               nlat))).reshape(1, -1, 1)

    def __call__(self, u, xb):
        """u: (69, nlat, nlon) control; xb: (69, *out_hw) background."""
        return resize_nearest(self.increment(u), self.out_hw) + xb

    def increment(self, u):
        """B^1/2 u on the solver grid, before the nearest upsample
        (da_4dvar.py:878-926); 3D-Var uses it for the reduced obs quadratic."""
        nlev = N_LEVELS
        inc = self.sht.isotropic_smooth(u, self.kernel_l0)
        inc = 11.0 * inc / self._len_scale ** 2

        u_blk = slice(N_SINGLE + 2 * nlev, N_SINGLE + 3 * nlev)
        if self.psi_wide:
            psi = torch.cat([inc[N_SINGLE : N_SINGLE + nlev], inc[u_blk]], dim=0)
        else:
            psi = inc[u_blk]
        vmode = inc + torch.einsum("ck,khw->chw", self._reg, psi)

        blocks = [vmode[:N_SINGLE] * self._std_sur]
        for i in range(5):
            blk = vmode[N_SINGLE + i * nlev : N_SINGLE + (i + 1) * nlev]
            blocks.append(torch.einsum("lk,khw->lhw", self._eof[i], blk))
        sfvp = torch.cat(blocks, dim=0)

        # psi/chi -> winds with the reference's exact stencils
        nlat = self.nlat

        def partial_x(f):
            fw = torch.roll(f, -1, dims=2)  # f[k+1]
            bw = torch.roll(f, 1, dims=2)  # f[k-1]
            return (bw - fw) / (2.0 * _EARTH_M_PER_DEG * 180.0 / nlat * self._x_scaling)

        dlat = _EARTH_M_PER_DEG * 180.0 / (nlat - 1)

        def partial_y(f):
            interior = (f[:, 2:] - f[:, :-2]) / (2.0 * dlat)
            first = (f[:, 1:2] - f[:, 0:1]) / dlat
            last = (f[:, -1:] - f[:, -2:-1]) / dlat
            return torch.cat([first, interior, last], dim=1)

        sf = sfvp[N_SINGLE + 2 * nlev : N_SINGLE + 3 * nlev]
        vp = sfvp[N_SINGLE + 3 * nlev : N_SINGLE + 4 * nlev]
        uwind = partial_y(sf) - partial_x(vp)
        vwind = -partial_x(sf) - partial_y(vp)
        return torch.cat([sfvp[: N_SINGLE + 2 * nlev], uwind, vwind,
                          sfvp[N_SINGLE + 4 * nlev :]], dim=0)
