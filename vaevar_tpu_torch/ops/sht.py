"""Real spherical harmonic transform: Legendre products and a real FFT.

Port of vaevar_tpu/ops/sht.py (the reference's torch_harmonics
RealSHT/InverseRealSHT on the equiangular grid, da_4dvar.py:617-618,
884-885, norm "ortho", csphase on). The quadrature weights and the
Legendre table are copies of the JAX package's numpy code (float64;
tests/test_torch_import.py holds them equal). The longitude transform is
`torch.fft.rfft`/`irfft`; the Legendre step multiplies the real and the
imaginary parts by the real table apiece, so the arithmetic stays f32 and
forward-mode AD needs no complex products:
- analysis:  f_lm = sum_j w_j Phat_lm(theta_j) * (2 pi / nlon) * rfft(f)_m(j)
- synthesis: f(j, k) = Re sum_m [sum_l f_lm Phat_lm(theta_j)] e^{i m phi_k}
  with m > 0 counted twice (irfft times nlon).
For a zonally symmetric kernel g, isht(scale_l * sht(f) * g_l0) is an
isotropic spherical convolution (the CVT's horizontal smoothing).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def clenshaw_curtis_weights(n: int) -> np.ndarray:
    """Quadrature weights for nodes x_j = cos(j*pi/(n-1)), j=0..n-1."""
    N = n - 1
    theta = np.pi * np.arange(n) / N
    w = np.zeros(n)
    v = np.ones(N - 1)
    if N % 2 == 0:
        w[0] = w[N] = 1.0 / (N**2 - 1)
        for k in range(1, N // 2):
            v -= 2.0 * np.cos(2.0 * k * theta[1:N]) / (4.0 * k**2 - 1)
        v -= np.cos(N * theta[1:N]) / (N**2 - 1)
    else:
        w[0] = w[N] = 1.0 / N**2
        for k in range(1, (N - 1) // 2 + 1):
            v -= 2.0 * np.cos(2.0 * k * theta[1:N]) / (4.0 * k**2 - 1)
    w[1:N] = 2.0 * v / N
    return w


@functools.lru_cache(maxsize=8)
def _legendre_table(nlat: int, lmax: int, mmax: int) -> np.ndarray:
    """Orthonormalized associated Legendre Phat[l, m, j] at the grid nodes.

    Phat_lm = (-1)^m sqrt((2l+1)/(4 pi) (l-m)!/(l+m)!) P_lm — WITH the
    Condon-Shortley phase, matching torch_harmonics' csphase=True default
    (the RealSHT the reference constructs at da_4dvar.py:617-618) and
    scipy's sph_harm_y, so coefficient arrays are directly comparable.
    float64 recurrences, returned as float64 (cast at use sites).
    """
    theta = np.pi * np.arange(nlat) / (nlat - 1)
    x = np.cos(theta)
    s = np.sin(theta)
    P = np.zeros((lmax, mmax, nlat))
    P[0, 0] = np.sqrt(1.0 / (4.0 * np.pi))
    # diagonal: Phat_mm (the -1 factor accumulates the CS phase (-1)^m)
    for m in range(1, mmax):
        if m < lmax:
            P[m, m] = -np.sqrt((2 * m + 1) / (2.0 * m)) * s * P[m - 1, m - 1]
    # first off-diagonal: Phat_{m+1,m}
    for m in range(mmax):
        if m + 1 < lmax:
            P[m + 1, m] = np.sqrt(2 * m + 3.0) * x * P[m, m]
    # upward recurrence in l
    for m in range(mmax):
        for l in range(m + 2, lmax):
            a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
            P[l, m] = a * (x * P[l - 1, m] - b * P[l - 2, m])
    return P


class SHT:
    """Real SHT on the (nlat, nlon) equiangular grid, its tables as f32
    tensors on `device`. Coefficients are complex (..., lmax, mmax) with
    lmax = nlat."""

    def __init__(self, nlat: int, nlon: int, mmax: int | None = None, device="cpu"):
        self.nlat = nlat
        self.nlon = nlon
        self.lmax = nlat
        self.mmax = mmax or (nlon // 2 + 1)
        P = _legendre_table(nlat, self.lmax, self.mmax)
        w = clenshaw_curtis_weights(nlat)
        self._P = torch.as_tensor(P, dtype=torch.float32, device=device)  # (l, m, j)
        self._Pw = torch.as_tensor(P * w[None, None, :], dtype=torch.float32, device=device)

    def analysis(self, x):
        """(..., nlat, nlon) real -> (..., lmax, mmax) complex coefficients."""
        F = torch.fft.rfft(x, dim=-1)[..., : self.mmax] * (2.0 * np.pi / self.nlon)
        return torch.complex(*(torch.einsum("lmj,...jm->...lm", self._Pw, part)
                               for part in (F.real, F.imag)))

    def synthesis(self, c):
        """(..., lmax, mmax) complex -> (..., nlat, nlon) real."""
        nfreq = self.nlon // 2 + 1
        parts = []
        for part in (c.real, c.imag):
            g = torch.einsum("lmj,...lm->...jm", self._P, part)
            if self.mmax < nfreq:
                g = torch.nn.functional.pad(g, (0, nfreq - self.mmax))
            parts.append(g)
        # hermitian synthesis without the 1/n of the standard irfft
        return torch.fft.irfft(torch.complex(*parts), n=self.nlon, dim=-1) * self.nlon

    def zonal_coeffs(self, profile):
        """m=0 coefficients (real) of a zonally-symmetric field given its
        latitude profile (..., nlat)."""
        return torch.einsum("lj,...j->...l", self._Pw[:, 0, :], 2.0 * np.pi * profile)

    def isotropic_smooth(self, x, kernel_l0):
        """isht(scale * sht(x) * g_l0): spherical convolution with a zonal
        kernel. kernel_l0: (..., lmax) broadcastable against x's batch dims;
        scale is the spherical convolution factor 2*pi*sqrt(4*pi/(2l+1))
        (reference da_4dvar.py:627-628)."""
        l = torch.arange(self.lmax, dtype=torch.float32, device=x.device)
        sph_scale = 2.0 * np.pi * torch.sqrt(4.0 * np.pi / (2.0 * l + 1.0))
        c = self.analysis(x)
        scale = (sph_scale * kernel_l0)[..., :, None]  # (..., l, 1) over m
        return self.synthesis(torch.complex(c.real * scale, c.imag * scale))


def gaussian_lat_kernel(hpad: int, nlat: int, len_scale, device="cpu") -> torch.Tensor:
    """Reference CVT kernel profile: rows i<hpad get exp(-i^2/(8 len^2)),
    rows >= hpad are zero (da_4dvar.py:620-625). len_scale: (C,) ->
    (C, nlat) f32."""
    i = torch.arange(nlat, dtype=torch.float32, device=device)
    mask = (i < hpad).to(torch.float32)
    ls = torch.as_tensor(np.asarray(len_scale), dtype=torch.float32, device=device)[..., None]
    return torch.exp(-(i ** 2) / (8.0 * ls ** 2)) * mask
