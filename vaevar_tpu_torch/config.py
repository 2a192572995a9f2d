"""Typed configuration for the LGUnet backbone and the DA cycle.

A copy of the dataclasses of vaevar_tpu/config.py that the port's slice
uses, so that the port runs without the JAX package. Field names and
defaults are the reference's (tests/test_torch_import.py holds them equal);
the port's modules read configs by attribute, so a reference config object
works in their place too. `LGUnetConfig.from_reference_dict` maps a
reference YAML `lgunet_all` block onto a config, as the reference's does.
`DAConfig` keeps the fields that the port's DA path reads.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class LGUnetConfig:
    img_size: tuple[int, int] = (128, 256)
    patch_size: tuple[int, int] = (2, 2)
    stride: tuple[int, int] = (2, 2)
    inchans_list: tuple[int, ...] = (4, 13, 13, 13, 13, 13)
    outchans_list: tuple[int, ...] = (4, 13, 13, 13, 13, 13)
    enc_dim: int = 96
    embed_dim: int = 1152
    window_size: tuple[int, int] = (4, 4)
    enc_depths: tuple[int, ...] = (2, 2)
    enc_heads: tuple[int, ...] = (3, 6)
    lg_depths: tuple[int, ...] = (4, 4, 4)
    lg_heads: tuple[int, ...] = (6, 6, 6)
    mlp_ratio: float = 4.0
    attn_type: str = "rope"  # "rope" (new-gen) | "relbias" (old-gen)
    lora_rank: int = 0
    lg_full_attn_first: bool = True  # new-gen: LG stage 0 attends the full grid
    remat: bool = False  # activation checkpointing per block under autograd
    dtype: Any = None  # compute dtype (None => float32); params stay f32
    flash_min_seq: int = 4096  # unmasked windows with N >= this use flash
    dilated_size: tuple[int, ...] = (1, 1)
    lg_window_size: tuple[int, ...] | None = None

    def __post_init__(self):
        if len(self.window_size) != 2:
            raise ValueError(
                "window_size is the enc/dec window and must be 2-D; use "
                "lg_window_size for a 3-D LG-stage window (the reference "
                "encoder cannot take 3-D windows either: SD_attn would "
                "mis-unpack 4-D input, Attention.py:577)"
            )
        if self.lg_window_size is not None and len(self.lg_window_size) == 3 \
                and self.lg_window_size[0] != 1:
            raise ValueError(
                "3-D LG windows run at T=1 (LG_net.forward hardcodes T=1, "
                "networks/LGUnet_all.py:728): lg_window_size[0] must be 1"
            )

    @property
    def lg_window(self) -> tuple[int, ...]:
        return self.lg_window_size or self.window_size

    @property
    def n_groups(self) -> int:
        return len(self.inchans_list)

    @property
    def patches_resolution(self) -> tuple[int, int]:
        return (self.img_size[0] // self.stride[0], self.img_size[1] // self.stride[1])

    @property
    def lg_resolution(self) -> tuple[int, int]:
        f = 2 ** (len(self.enc_depths) - 1)
        pr = self.patches_resolution
        return (pr[0] // f, pr[1] // f)

    @property
    def out_chans(self) -> int:
        return sum(self.outchans_list)

    @property
    def in_chans(self) -> int:
        return sum(self.inchans_list)

    def replace(self, **kw) -> "LGUnetConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_reference_dict(
        cls, d: dict, attn_type: str = "rope", **overrides
    ) -> "LGUnetConfig":
        """Build from a reference-style params dict (YAML `lgunet_all` block)."""

        def pair(v) -> tuple[int, int]:
            if isinstance(v, (list, tuple)):
                return (int(v[-2]), int(v[-1]))
            return (int(v), int(v))

        kw = dict(
            img_size=pair(d["img_size"]),
            patch_size=pair(d.get("patch_size", (2, 2))),
            stride=pair(d.get("stride", (2, 2))),
            inchans_list=tuple(d["inchans_list"]),
            outchans_list=tuple(d["outchans_list"]),
            enc_dim=int(d.get("enc_dim", 96)),
            embed_dim=int(d.get("embed_dim", 1152)),
            window_size=pair(d.get("window_size", (4, 4))),
            enc_depths=tuple(d.get("enc_depths", (2, 2))),
            enc_heads=tuple(d.get("enc_heads", (3, 6))),
            lg_depths=tuple(d.get("lg_depths", ())),
            lg_heads=tuple(d.get("lg_heads", ())),
            attn_type=attn_type,
            lora_rank=int(d.get("rank", 0)),
            lg_full_attn_first=attn_type == "rope",
            remat=bool(d.get("use_checkpoint", False)),
        )
        kw.update(overrides)
        return cls(**kw)


#: 0.25 deg forecast model (new-gen rope, full-grid LG stage 0).
FORECAST_025 = LGUnetConfig(
    img_size=(721, 1440), patch_size=(3, 2), stride=(2, 2),
    inchans_list=(4, 13, 13, 13, 13, 13), outchans_list=(8, 26, 26, 26, 26, 26),
    enc_dim=96, embed_dim=1152, window_size=(6, 12), enc_depths=(2, 2, 2),
    enc_heads=(3, 6, 6), lg_depths=(4, 4, 4), lg_heads=(6, 6, 6),
    attn_type="rope", remat=True,
)

#: 1.4 deg flow model (old-gen relbias), the advance when no 0.25 deg model runs.
FLOW_140 = LGUnetConfig(
    img_size=(128, 256), patch_size=(2, 2), stride=(2, 2),
    inchans_list=(4, 13, 13, 13, 13, 13), outchans_list=(8, 26, 26, 26, 26, 26),
    enc_dim=96, embed_dim=1152, window_size=(4, 4), enc_depths=(2, 2),
    enc_heads=(3, 6), lg_depths=(4, 4, 4), lg_heads=(6, 6, 6),
    attn_type="relbias", lg_full_attn_first=False,
)

#: VAE encoder: 69 ch -> 64 ch = mu || logvar (old-gen relbias).
VAE_ENCODER = LGUnetConfig(
    img_size=(128, 256), patch_size=(2, 2), stride=(2, 2),
    inchans_list=(4, 13, 13, 13, 13, 13), outchans_list=(4, 12, 12, 12, 12, 12),
    enc_dim=96, embed_dim=1152, window_size=(4, 4), enc_depths=(2, 2),
    enc_heads=(3, 6), lg_depths=(4, 4, 4), lg_heads=(6, 6, 6),
    attn_type="relbias", lg_full_attn_first=False,
)

#: VAE decoder: latent 32 ch -> 69 ch, the operator of the vae4dvar cost.
VAE_DECODER = VAE_ENCODER.replace(
    inchans_list=(2, 6, 6, 6, 6, 6),
    outchans_list=(4, 13, 13, 13, 13, 13),
)


def micro_config(img_size=(16, 32), attn_type="rope", **overrides) -> LGUnetConfig:
    """Minimal topology-preserving config for CPU runs."""
    kw = dict(
        img_size=img_size, patch_size=(2, 2), stride=(2, 2),
        inchans_list=(4, 13, 13, 13, 13, 13),
        outchans_list=(8, 26, 26, 26, 26, 26),
        enc_dim=4, embed_dim=16, window_size=(4, 4), enc_depths=(1, 1),
        enc_heads=(1, 1), lg_depths=(1,), lg_heads=(1,), attn_type=attn_type,
        lg_full_attn_first=attn_type == "rope",
    )
    kw.update(overrides)
    return LGUnetConfig(**kw)


def micro_vae_configs(img_size=(16, 32)):
    """Micro (encoder, decoder) pair with the VAE topology: latent 8 ch."""
    enc = micro_config(img_size=img_size, attn_type="relbias",
                       inchans_list=(13, 56), outchans_list=(2, 14))
    dec = enc.replace(inchans_list=(2, 6), outchans_list=(13, 56))
    return enc, dec


def micro_vae_train_configs(img_size=(16, 32), **overrides):
    """run_train_vae.py --micro's (flow, encoder, decoder) (run_train_vae.py:
    91-95): the micro relbias config with the VAE's six groups, latent 32."""
    flow = micro_config(img_size=img_size, attn_type="relbias", **overrides)
    enc = flow.replace(outchans_list=(4, 12, 12, 12, 12, 12))
    dec = flow.replace(inchans_list=(2, 6, 6, 6, 6, 6), outchans_list=(4, 13, 13, 13, 13, 13))
    return flow, enc, dec


def tiny_config(
    img_size=(32, 64), attn_type="rope", lg_full_attn_first=True
) -> LGUnetConfig:
    """Small config for tests: same topology, tiny dims."""
    return LGUnetConfig(
        img_size=img_size,
        patch_size=(2, 2),
        stride=(2, 2),
        inchans_list=(4, 13, 13, 13, 13, 13),
        outchans_list=(8, 26, 26, 26, 26, 26),
        enc_dim=8,
        embed_dim=48,
        window_size=(4, 4),
        enc_depths=(2, 2),
        enc_heads=(2, 2),
        lg_depths=(2, 2),
        lg_heads=(2, 2),
        attn_type=attn_type,
        lg_full_attn_first=lg_full_attn_first,
    )


@dataclass(frozen=True)
class DAConfig:
    """Cycled DA configuration, 3D-Var and the 4D-Var window (the fields of
    vaevar_tpu.config.DAConfig that the port reads, same defaults)."""

    da_mode: str = "vae4dvar"  # free_run | interpolation | sc4dvar | vae4dvar
    da_win: int = 1  # hourly slots in the window (1 => 3D-Var)
    nit: int = 4  # outer iterations (L-BFGS segments)
    lbfgs_iters: int = 10  # quasi-Newton iterations per segment
    lbfgs_history: int = 10
    obs_std: float = 0.005
    obs_coeff: float = 1.0
    filter_coeff: float = 0.1  # real-obs QC: keep |yo - gt| < filter_coeff * sigma
    obs_type: str = "column_random_0001"
    q_type: int = 1  # model error Q in R for slots >= 1 (da/obs.load_q_matrix)
    scale_factor: float = 2.0  # sc4dvar B length scales (ROADMAP A.10)
    modify_tp: int = 2
    interp_dim: int = 40  # observation levels of real obs: 4 + 5 * interp_dim channels
    init_lag: int = 8
    init_tp: int = 0  # spin-up: 0 forecast init_lag steps, 1 truth, 2 truth of 183 days before
    save_interval: int = 5
    use_eval: bool = False  # hold out obs cells (mask_eval) and report error_obs
    latent_shape: tuple[int, ...] = (1, 32, 128, 256)
    grid_hw: tuple[int, int] = (721, 1440)  # analysis grid
    solver_hw: tuple[int, int] = (128, 256)  # latent grid
    # one torch.utils.checkpoint per rollout step inside the window cost
    window_step_checkpoint: bool = True
    lbfgs_max_evals: int | None = None  # None => lbfgs_iters * 5 // 4
    # "auto" resolves at the first solve: "jvp-zoom" (forward-mode probes)
    # when the cost runs under torch.func.jvp, "zoom" when it runs the flash
    # attention op, which has no forward-mode rule
    lbfgs_linesearch: str = "auto"

    def replace(self, **kw) -> "DAConfig":
        return dataclasses.replace(self, **kw)
