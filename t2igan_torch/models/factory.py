"""Model builders wired to the Config (port of
:mod:`t2igan.models.factory`)."""

from __future__ import annotations

import os
from typing import List, Union

import torch

from t2igan_torch.config import Config
from t2igan_torch.models.clip import ClipConfig, ClipWithRegionHead, init_clip_
from t2igan_torch.models.convert import load_clip_pth
from t2igan_torch.models.discriminator import DNetWithHeads
from t2igan_torch.models.generator import GDCGan, GNet


def build_generator(cfg: Config) -> Union[GNet, GDCGan]:
    """The generator the config names (``GDCGan`` under ``GAN.B_DCGAN``,
    else ``GNet``), in eval mode, f32 on the CPU (move it with
    ``.to(device, dtype)``).  ``GAN.FUSED_TAIL`` runs each eval-mode stage
    tail through the fused tail kernel (K3)."""
    cls = GDCGan if cfg.GAN.B_DCGAN else GNet
    return cls(gf_dim=cfg.GAN.GF_DIM, nef=cfg.TEXT.EMBEDDING_DIM,
               condition_dim=cfg.GAN.CONDITION_DIM, z_dim=cfg.GAN.Z_DIM,
               branch_num=cfg.TREE.BRANCH_NUM, num_residual=cfg.GAN.R_NUM,
               upblock=cfg.GAN.UPBLOCK,
               fused_tail=cfg.GAN.FUSED_TAIL).eval()


def build_discriminators(cfg: Config) -> List[DNetWithHeads]:
    """One discriminator per pyramid branch; under ``GAN.B_DCGAN`` only the
    finest-scale one, without the unconditional head.  f32 on the CPU,
    weights uninitialised (``init_discriminator_`` or a loader fills
    them)."""
    if min(cfg.branch_sizes) < 64:
        raise ValueError(
            f"discriminators need >=64^2 inputs (the trunk downsamples 16x "
            f"to a 4x4 code) but the pyramid is {cfg.branch_sizes}; raise "
            f"TREE.BASE_SIZE to at least 64")
    if cfg.GAN.B_DCGAN:
        return [DNetWithHeads(cfg.GAN.DF_DIM, cfg.TEXT.EMBEDDING_DIM,
                              cfg.final_size, b_jcu=False)]
    return [DNetWithHeads(cfg.GAN.DF_DIM, cfg.TEXT.EMBEDDING_DIM, size)
            for size in cfg.branch_sizes]


def build_clip(clip_cfg: ClipConfig = ClipConfig()) -> ClipWithRegionHead:
    """The full joint encoder (both towers, projections, region head), in
    eval mode, f32 on the CPU, weights uninitialised (``init_clip_`` or
    ``load_jax_clip`` fills them)."""
    return ClipWithRegionHead(clip_cfg).eval()


def load_clip(cfg: Config, clip_cfg: ClipConfig = ClipConfig(),
              generator: torch.Generator = None) -> ClipWithRegionHead:
    """CLIP for training (``t2igan.train.pretrain_damsm.build_clip``): the
    weights of ``TRAIN.CLIP_MODEL_CHECKPOINT`` when it names an existing
    ``.pth``/``.pt`` file (a ``clip%d.pth``, :func:`load_clip_pth`), else
    random weights drawn from ``generator`` (``init_clip_``), with a
    warning when a checkpoint was named.  Loading draws nothing from
    ``generator``.  In eval mode, f32 on the CPU."""
    clip = build_clip(clip_cfg)
    ckpt = cfg.TRAIN.CLIP_MODEL_CHECKPOINT
    if ckpt and os.path.isfile(ckpt) and ckpt.endswith((".pth", ".pt")):
        load_clip_pth(clip, ckpt)
        print(f"Loaded CLIP weights from torch checkpoint: {ckpt}")
        return clip
    init_clip_(clip, generator)
    if ckpt:
        print(f"WARNING: CLIP checkpoint {ckpt!r} not found; "
              "starting from random initialization.")
    return clip
