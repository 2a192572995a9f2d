"""Background-error VAE: encoder, reparameterized sampler, decoder.

Port of vaevar_tpu/models/vae.py:26-65 (the reference `VAE_lr`,
nf_model/vae.py:53-107): encoder and decoder are old-gen LGUnet backbones,
the encoder's output splits in half along channels into (mu, logvar), and
`decoder_hr` resizes the decoded field to 721x1440 with torch-nearest
semantics. The two halves sit under `enc.` and `dec.`, the reference's key
prefixes (vaevar_tpu/utils/port_torch.py:222-228), so a reference `VAE_lr`
state_dict loads as is. The DA engine runs only the decoder.

The ELBO follows nf_model/vae.py:104-107:
    loss = sum((recon-x)^2)/(2 sigma^2) - 0.5 sum(1 + logvar - mu^2 - e^logvar)
"""

from __future__ import annotations

import torch
from torch import nn

from vaevar_tpu_torch.config import VAE_DECODER, VAE_ENCODER
from vaevar_tpu_torch.models.lgunet import LGUnet
from vaevar_tpu_torch.ops.interp import resize_nearest


class VAE(nn.Module):
    """Latent background-error model. Latent: (B, latent_ch, H', W')."""

    def __init__(self, enc_cfg=VAE_ENCODER, dec_cfg=VAE_DECODER):
        super().__init__()
        self.enc = LGUnet(enc_cfg)
        self.dec = LGUnet(dec_cfg)

    def encoder(self, x):
        """(B, C, H, W) -> (mu, logvar) each (B, latent_ch, H', W')."""
        mu, logvar = torch.chunk(self.enc(x), 2, dim=1)
        return mu, logvar

    def sampling(self, mu, logvar, generator: torch.Generator | None = None, eps=None):
        """mu + eps * exp(logvar / 2), with eps drawn from `generator` in
        std's type unless the caller gives it."""
        std = torch.exp(0.5 * logvar)
        if eps is None:
            eps = torch.randn(std.shape, generator=generator, dtype=std.dtype,
                              device=std.device)
        return mu + eps.to(std.dtype) * std

    def decoder(self, z):
        return self.dec(z)

    def decoder_hr(self, z, out_hw=(721, 1440)):
        return resize_nearest(self.dec(z), out_hw)

    def forward(self, x, generator: torch.Generator | None = None, eps=None):
        mu, logvar = self.encoder(x)
        z = self.sampling(mu, logvar, generator, eps)
        return self.decoder(z), mu, logvar


def elbo_loss(recon_x, x, mu, logvar, sigma: float):
    """Returns (total, reconstruction_sse, kld) like nf_model/vae.py:104-107."""
    sse = torch.sum((recon_x - x) ** 2)
    mse = sse / (2.0 * sigma ** 2)
    kld = -0.5 * torch.sum(1.0 + logvar - mu ** 2 - torch.exp(logvar))
    return mse + kld, sse, kld
