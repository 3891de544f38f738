"""Train states, optimizers and the G EMA of the adversarial and DAMSM
steps (port of :mod:`t2igan.train.state`).

PyTorch keeps optimizer state inside the optimizer, so where the JAX
package hands ``g_tx``/``d_tx``/``tx`` to the step, the port hands
optimizer factories to :func:`init_gan_state` (``params ->
torch.optim.Optimizer``, one optimizer for G and one per discriminator)
and :func:`init_damsm_state` (``CLIP module -> DamsmOptimizer``).
Parameters, optimizer state and the EMA stay f32 whatever precision the
forwards run in.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

from t2igan_torch.config import Config
from t2igan_torch.models.clip import ClipWithRegionHead
from t2igan_torch.models.discriminator import DNetWithHeads
from t2igan_torch.models.generator import GNet
from t2igan_torch.train.schedule import cosine_onecycle

OptimizerFactory = Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]


@dataclasses.dataclass
class GanTrainState:
    """G, its EMA copy, the discriminators and their optimizers; ``step``
    counts the updates taken.  The step updates the modules in place."""

    gen: GNet
    gen_ema: GNet
    ds: List[DNetWithHeads]
    g_opt: torch.optim.Optimizer
    d_opts: List[torch.optim.Optimizer]
    step: int = 0


def gan_optimizers(cfg: Config) -> Tuple[OptimizerFactory, OptimizerFactory]:
    """(G, D) factories: Adam with lr ``TRAIN.GENERATOR_LR`` /
    ``TRAIN.DISCRIMINATOR_LR``, betas (0.5, 0.999) and eps 1e-8, as
    ``optax.adam`` in the JAX package."""

    def adam(lr: float) -> OptimizerFactory:
        return lambda params: torch.optim.Adam(params, lr=lr,
                                               betas=(0.5, 0.999), eps=1e-8)

    return adam(cfg.TRAIN.GENERATOR_LR), adam(cfg.TRAIN.DISCRIMINATOR_LR)


@torch.no_grad()
def ema_update(ema: nn.Module, model: nn.Module,
               decay: float = 0.999) -> None:
    """``avg = decay * avg + (1 - decay) * p`` over the parameters; the
    buffers (the BN running statistics) are copied from ``model``, not
    averaged.  The JAX package keeps one set of batch statistics, the
    trained G's, and samples the EMA parameters with it; so do
    ``netG_epoch_%d.pth`` and the ``.npz`` export.  Both copies are
    in place, which moves each tensor's ``_version`` and so refreshes the
    fused tail's cached operands."""
    for e, p in zip(ema.parameters(), model.parameters()):
        e.copy_(decay * e + (1.0 - decay) * p)
    for e, b in zip(ema.buffers(), model.buffers()):
        e.copy_(b)


def init_gan_state(cfg: Config, gen: GNet, ds: List[DNetWithHeads],
                   g_tx: Optional[OptimizerFactory] = None,
                   d_tx: Optional[OptimizerFactory] = None) -> GanTrainState:
    """The train state around initialised models: the EMA starts as a copy
    of G, and the optimizers come from the factories (default
    :func:`gan_optimizers`)."""
    if g_tx is None or d_tx is None:
        g_def, d_def = gan_optimizers(cfg)
        g_tx, d_tx = g_tx or g_def, d_tx or d_def
    gen_ema = copy.deepcopy(gen).requires_grad_(False)
    return GanTrainState(gen=gen, gen_ema=gen_ema, ds=list(ds),
                         g_opt=g_tx(gen.parameters()),
                         d_opts=[d_tx(d.parameters()) for d in ds])


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: with ``norm`` the l2 norm
    over all of ``grads``, each stays as it is if ``norm < max_norm`` and
    becomes ``g / norm * max_norm`` otherwise (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``).  Returns ``norm`` as an f32 0-dim
    tensor, without a host synchronisation.

    The norm is summed in float64 and then rounded to f32: PyTorch's CPU
    f32 norm keeps a running f32 sum, whose error grows with the tensor
    (CLIP's token embedding has 25M entries), and Adam turns a clip factor
    that is slightly off into a different step wherever a clipped
    gradient is near its eps."""
    norm = torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(grads, 2, dtype=torch.float64))).float()
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, max_norm))
    return norm


class DamsmOptimizer:
    """The DAMSM update, as the JAX package's optax chain:
    ``clip_by_global_norm(max_norm)``, then Adam (b1 0.9, b2 0.98, eps
    1e-8 outside the square root, bias-corrected) in two groups, each with
    its own learning-rate schedule.

    ``groups`` maps a group's name to its parameters and ``schedules`` maps
    it to ``count -> lr``.  :meth:`step` reads each parameter's ``.grad``
    (``None`` counts as zeros, as optax sees the gradient of a parameter
    the loss does not use: it enters the norm as 0 and Adam leaves the
    parameter exactly as it was), clips, sets each group's lr to
    ``schedule(count)`` with ``count`` the updates taken so far, and
    updates."""

    def __init__(self, groups: Dict[str, List[nn.Parameter]],
                 schedules: Dict[str, Callable[[int], float]],
                 max_norm: float):
        self.schedules = schedules
        self.max_norm = max_norm
        self.count = 0
        self.params = [p for ps in groups.values() for p in ps]
        self.adam = torch.optim.Adam(
            [{"params": ps, "name": name} for name, ps in groups.items()],
            lr=0.0, betas=(0.9, 0.98), eps=1e-8)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update; returns the global norm of the gradients before the
        clip (a 0-dim tensor, no host synchronisation)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = clip_by_global_norm_([p.grad for p in self.params],
                                    self.max_norm)
        for group in self.adam.param_groups:
            group["lr"] = self.schedules[group["name"]](self.count)
        self.adam.step()
        self.count += 1
        return norm


DamsmOptimizerFactory = Callable[[ClipWithRegionHead], DamsmOptimizer]


def damsm_optimizer(cfg: Config,
                    steps_per_epoch: int) -> DamsmOptimizerFactory:
    """The factory of the DAMSM update (``t2igan.train.state.
    damsm_optimizer``): parameters under ``linear_subr`` form the "linear"
    group, all others (``logit_scale`` included) the "backbone" group;
    both schedules run over ``steps_per_epoch * TRAIN.MAX_EPOCH`` steps:
    backbone peak ``TRAIN.BACKBONE_LR``, pct 0.02, div 25, final div 1e4;
    linear peak ``TRAIN.LINEAR_LR``, pct 0.1, div 1e3, final div 1e6.  The
    clip is at ``TRAIN.RNN_GRAD_CLIP``."""
    total = max(1, steps_per_epoch * cfg.TRAIN.MAX_EPOCH)
    schedules = {
        "backbone": cosine_onecycle(total, cfg.TRAIN.BACKBONE_LR,
                                    pct_start=0.02, div_factor=25.0,
                                    final_div_factor=1e4),
        "linear": cosine_onecycle(total, cfg.TRAIN.LINEAR_LR, pct_start=0.1,
                                  div_factor=1e3, final_div_factor=1e6)}

    def make(clip: ClipWithRegionHead) -> DamsmOptimizer:
        groups: Dict[str, List[nn.Parameter]] = {"backbone": [],
                                                 "linear": []}
        for name, p in clip.named_parameters():
            linear = "linear_subr" in name.split(".")
            groups["linear" if linear else "backbone"].append(p)
        return DamsmOptimizer(groups, schedules, cfg.TRAIN.RNN_GRAD_CLIP)

    return make


@dataclasses.dataclass
class DamsmTrainState:
    """The CLIP being fine-tuned and its optimizer; the step updates both
    in place."""

    clip: ClipWithRegionHead
    opt: DamsmOptimizer

    @property
    def step(self) -> int:
        """Updates taken."""
        return self.opt.count


def init_damsm_state(cfg: Config, clip: ClipWithRegionHead,
                     tx: DamsmOptimizerFactory) -> DamsmTrainState:
    """The DAMSM train state around an initialised CLIP (trainable, every
    parameter in the optimizer)."""
    del cfg
    return DamsmTrainState(clip=clip.requires_grad_(True), opt=tx(clip))
