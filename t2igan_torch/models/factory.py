"""Model builders wired to the Config (port of
``t2igan.models.factory.build_generator``)."""

from __future__ import annotations

from t2igan_torch.config import Config
from t2igan_torch.models.generator import GNet


def build_generator(cfg: Config) -> GNet:
    """The generator the config names, in eval mode, f32 on the CPU (move
    it with ``.to(device, dtype)``).

    Raises ``NotImplementedError`` for what the port does not have yet:
    ``GAN.FUSED_TAIL`` (the fused stage-tail kernel, ROADMAP.md Queue 2 K3)
    and ``GAN.B_DCGAN`` (``GDCGan``, ROADMAP.md Queue 1)."""
    if cfg.GAN.FUSED_TAIL:
        raise NotImplementedError(
            "GAN.FUSED_TAIL selects the fused eval stage tail, a TPU kernel "
            "the port has not ported yet (ROADMAP.md, Queue 2, K3); set "
            "GAN.FUSED_TAIL: False")
    if cfg.GAN.B_DCGAN:
        raise NotImplementedError(
            "GAN.B_DCGAN selects GDCGan, which the port has not ported yet "
            "(ROADMAP.md, Queue 1)")
    return GNet(gf_dim=cfg.GAN.GF_DIM, nef=cfg.TEXT.EMBEDDING_DIM,
                condition_dim=cfg.GAN.CONDITION_DIM, z_dim=cfg.GAN.Z_DIM,
                branch_num=cfg.TREE.BRANCH_NUM, num_residual=cfg.GAN.R_NUM,
                upblock=cfg.GAN.UPBLOCK).eval()
