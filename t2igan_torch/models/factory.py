"""Model builders wired to the Config (port of
:mod:`t2igan.models.factory`)."""

from __future__ import annotations

from typing import List

from t2igan_torch.config import Config
from t2igan_torch.models.clip import ClipConfig, ClipWithRegionHead
from t2igan_torch.models.discriminator import DNetWithHeads
from t2igan_torch.models.generator import GNet


def build_generator(cfg: Config) -> GNet:
    """The generator the config names, in eval mode, f32 on the CPU (move
    it with ``.to(device, dtype)``).

    ``GAN.FUSED_TAIL`` runs each eval-mode stage tail through the fused
    tail kernel (K3).  Raises ``NotImplementedError`` on ``GAN.B_DCGAN``
    (``GDCGan``, which the port does not have yet, ROADMAP.md Queue 1)."""
    if cfg.GAN.B_DCGAN:
        raise NotImplementedError(
            "GAN.B_DCGAN selects GDCGan, which the port has not ported yet "
            "(ROADMAP.md, Queue 1)")
    return GNet(gf_dim=cfg.GAN.GF_DIM, nef=cfg.TEXT.EMBEDDING_DIM,
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
