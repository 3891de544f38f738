"""Faults planted under the timed path, to show that the comparison
catches them: each wraps one factory of the program for the length of a
``with`` block, so that what the entry builds inside it is broken.

* ``unchanged`` (train): the step runs, then the modules' parameters and
  buffers are put back as they were: a step that returns its state
  unchanged.
* ``half_batch``: the call runs on the first half of its rows; a train
  step takes the mean over those, a sampler or rank fn repeats them for
  the other half.
* ``altered``: one answer altered where it is produced: the first
  image's finest pixels negated, or the first query's true score raised
  by 0.05.
"""

from __future__ import annotations

import contextlib
import copy

import torch

FAULTS = {"train": ("unchanged", "half_batch"),
          "sample": ("altered", "half_batch"),
          "sweep": ("altered", "half_batch")}


def _half(x):
    if isinstance(x, list):
        return [_half(v) for v in x]
    return x[:x.shape[0] // 2]


@contextlib.contextmanager
def planted(entry: str, fault: str):
    """Inside the block, the factory that ``entry`` calls builds a path
    with ``fault``."""
    if fault not in FAULTS[entry]:
        raise ValueError(f"no fault {fault!r} for entry {entry!r}")
    if entry == "train":
        import t2igan_torch.train.train_gan as mod
        name = "make_gan_step"
    elif entry == "sample" or entry == "sweep" and fault == "half_batch":
        import t2igan_torch.train.steps as mod
        name = "make_sampler"
    else:
        import t2igan_torch.evaluation.rprecision as mod
        name = "make_rank_fn"
    real = getattr(mod, name)

    def broken(*args, **kwargs):
        fn = real(*args, **kwargs)
        if entry == "train":
            return _train(fn, fault)
        if name == "make_sampler":
            return _sample(fn, fault)
        return _rank(fn)

    setattr(mod, name, broken)
    try:
        yield
    finally:
        setattr(mod, name, real)


def _train(step, fault):
    def wrapped(state, batch, **kw):
        if fault == "half_batch":
            return step(state, {k: _half(v) for k, v in batch.items()}, **kw)
        mods = [state.gen, state.gen_ema, *state.ds]
        saved = [copy.deepcopy(m.state_dict()) for m in mods]
        out = step(state, batch, **kw)
        for m, s in zip(mods, saved):
            m.load_state_dict(s)
        return out
    return wrapped


def _sample(sample, fault):
    def wrapped(ids, mask, z, eps):
        if fault == "half_batch":
            fakes = sample(*(_half(x) for x in (ids, mask, z, eps)))
            return [torch.cat([f, f]) for f in fakes]
        fakes = list(sample(ids, mask, z, eps))
        fakes[-1] = fakes[-1].clone()
        fakes[-1][0] = -fakes[-1][0]
        return fakes
    return wrapped


def _rank(rank):
    def wrapped(images, ids, mask, mis_ids, mis_mask):
        flags, scores = rank(images, ids, mask, mis_ids, mis_mask)
        scores = scores.clone()
        scores[0, 0] += 0.05
        return scores.argmax(-1) == 0, scores
    return wrapped
