"""Train-state checkpoints, epoch names and a clean stop (port of
:mod:`t2igan.train.checkpoint`).

The JAX package keeps its full train state in an orbax directory; the
card machine has no orbax, so the port keeps its own: one ``torch.save``
file per saved step, ``<output>/Model/state_<step>.pt``, the newest
``max_to_keep`` (5, as the JAX manager) kept.  A GAN state holds G, the
EMA G and every discriminator (parameters, BN running statistics, the
spectral-norm ``u``/``v``), both Adam states, ``step``, the epochs done,
the noise generator's state, the loader's epoch count (which orders every
epoch), the dataset generator's state after the last batch taken (crops,
flips and captions), and, for an epoch stopped part-way, that epoch's
permutation and the batches done, so that a resumed run draws the same
streams and takes the same batches as one that never stopped.
A DAMSM state holds CLIP and its ``DamsmOptimizer`` (both Adam groups and
``count``, on which the one-cycle learning rates depend).

The inference artifacts (``netG_epoch_%d.pth``, ``netD%d.pth``,
``clip%d.pth``, the ``.npz``) are written by
:mod:`t2igan_torch.models.convert` and :mod:`t2igan_torch.train.export`.
"""

from __future__ import annotations

import os
import re
import signal
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from t2igan_torch.train.state import DamsmTrainState, GanTrainState

_STATE = re.compile(r"^state_(\d+)\.pt$")


class CheckpointManager:
    """Step-indexed full train states in ``directory``."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"state_{step:08d}.pt")

    def steps(self) -> List[int]:
        """The saved steps, oldest first."""
        return sorted(int(m.group(1)) for m in map(
            _STATE.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, payload: Dict[str, Any]) -> str:
        """Write ``payload`` for ``step`` (through a temporary file, so a
        stop mid-write leaves the older states whole), then drop all but
        the newest ``max_to_keep``."""
        path = self.path(step)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
        return path

    def restore(self, step: Optional[int] = None
                ) -> Tuple[Optional[Dict[str, Any]], Optional[int]]:
        """(payload, step) of ``step`` (default the newest), or (None,
        None) when nothing is saved."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True), step


def gan_payload(state: GanTrainState, epoch: int, noise: torch.Generator,
                loader_epoch: int, data_rng: Optional[Dict[str, Any]],
                epoch_left: Optional[Tuple[np.ndarray, int]] = None
                ) -> Dict[str, Any]:
    """The full GAN train state after ``epoch`` epochs; ``loader_epoch`` is
    the loader's epoch count, ``data_rng`` the dataset generator's state
    (None for a dataset without one), ``epoch_left`` (the permutation,
    batches done) of an epoch stopped part-way."""
    perm, done = epoch_left if epoch_left is not None else (None, 0)
    return {"gen": state.gen.state_dict(),
            "gen_ema": state.gen_ema.state_dict(),
            "ds": [d.state_dict() for d in state.ds],
            "g_opt": state.g_opt.state_dict(),
            "d_opts": [o.state_dict() for o in state.d_opts],
            "step": state.step, "epoch": epoch,
            "epoch_order": None if perm is None else torch.from_numpy(perm),
            "batches_done": done,
            "noise": noise.get_state(),
            "loader_epoch": loader_epoch, "data_rng": data_rng}


def restore_gan_payload(state: GanTrainState, payload: Dict[str, Any],
                        noise: torch.Generator) -> Dict[str, Any]:
    """Load :func:`gan_payload`'s ``payload`` into ``state`` and the noise
    generator, in place; returns ``epoch`` (epochs done), ``epoch_left``
    (the stopped epoch's permutation and batches done, or None),
    ``loader_epoch`` and ``data_rng``."""
    if len(payload["ds"]) != len(state.ds):
        raise ValueError(f"the saved state has {len(payload['ds'])} "
                         f"discriminators, the config {len(state.ds)}")
    state.gen.load_state_dict(payload["gen"])
    state.gen_ema.load_state_dict(payload["gen_ema"])
    for d, sd in zip(state.ds, payload["ds"]):
        d.load_state_dict(sd)
    state.g_opt.load_state_dict(payload["g_opt"])
    for o, sd in zip(state.d_opts, payload["d_opts"]):
        o.load_state_dict(sd)
    for opt in (state.g_opt, *state.d_opts):
        for group in opt.param_groups:
            # The card's graphs make Adam capturable, which it cannot be
            # off the card.
            if group.get("capturable") and not all(
                    p.is_cuda for p in group["params"]):
                group["capturable"] = False
    state.step = int(payload["step"])
    noise.set_state(payload["noise"])
    perm = payload["epoch_order"]
    return {"epoch": int(payload["epoch"]),
            "epoch_left": None if perm is None else (
                perm.numpy(), int(payload["batches_done"])),
            "loader_epoch": int(payload["loader_epoch"]),
            "data_rng": payload["data_rng"]}


def damsm_payload(state: DamsmTrainState, epoch: int) -> Dict[str, Any]:
    """The full DAMSM train state after ``epoch`` epochs."""
    return {"clip": state.clip.state_dict(),
            "adam": state.opt.adam.state_dict(),
            "count": state.opt.count, "epoch": epoch}


def restore_damsm_payload(state: DamsmTrainState,
                          payload: Dict[str, Any]) -> int:
    """Load :func:`damsm_payload`'s ``payload`` into ``state`` in place;
    returns the epochs done."""
    state.clip.load_state_dict(payload["clip"])
    state.opt.adam.load_state_dict(payload["adam"])
    state.opt.count = int(payload["count"])
    return int(payload["epoch"])


class GracefulShutdown:
    """A stop flag set by SIGTERM or SIGINT: the training loop finishes
    its step, saves the full state and returns, and a resumed run picks up
    from that step, at the next batch of the stopped epoch.  :meth:`restore` puts the previous handlers back."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except (ValueError, OSError):
                pass  # not the main thread, or not a signal here

    def _handler(self, signum, frame):
        self.requested = True

    def restore(self):
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):
                pass


def parse_epoch_from_path(path: str) -> int:
    """Epoch from a reference-style checkpoint name, e.g.
    ``.../netG_epoch_550.pth`` -> 550; 0 without trailing digits."""
    m = re.search(r"(\d+)(?:\.[A-Za-z]+)?$", path)
    return int(m.group(1)) if m else 0
