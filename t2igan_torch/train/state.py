"""The adversarial step's train state, optimizers and EMA (port of
:mod:`t2igan.train.state`).

PyTorch keeps optimizer state inside the optimizer, so where the JAX
package hands ``g_tx``/``d_tx`` to the step, the port hands optimizer
factories (``params -> torch.optim.Optimizer``) to :func:`init_gan_state`,
which builds one optimizer for G and one per discriminator.  Parameters,
optimizer state and the EMA stay f32 whatever precision the forwards run
in.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Iterable, List, Optional, Tuple

import torch
from torch import nn

from t2igan_torch.config import Config
from t2igan_torch.models.discriminator import DNetWithHeads
from t2igan_torch.models.generator import GNet

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
    """``avg = decay * avg + (1 - decay) * p`` over the parameters; buffers
    (the BN running statistics) are not averaged."""
    for e, p in zip(ema.parameters(), model.parameters()):
        e.copy_(decay * e + (1.0 - decay) * p)


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
