"""Rank programs of ``tests/test_torch_port_parallel.py``.

They run in processes started by
:func:`t2igan_torch.parallel.mesh.spawn_local`, so this module imports
torch and the port only: no JAX, no ``t2igan``.  Each takes the rank's
:class:`DataMesh` first and returns tensors and plain values, which the
test compares with the JAX package in its own process.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import signal
import time

import numpy as np
import torch

from t2igan_torch.models.convert import save_clip_pth
from t2igan_torch.models.factory import (build_clip, build_discriminators,
                                         build_generator)
from t2igan_torch.models.generator import BatchNorm, global_batch_stats
from t2igan_torch.ops.kernels import LAUNCHES
from t2igan_torch.parallel import tp
from t2igan_torch.parallel.mesh import DataMesh
from t2igan_torch.train import train_gan
from t2igan_torch.train.pretrain_damsm import DamsmTrainer, data_rng_state
from t2igan_torch.train.state import (damsm_optimizer, init_damsm_state,
                                      init_gan_state)
from t2igan_torch.train.steps import (make_damsm_loss, make_damsm_step,
                                      make_gan_step)
from t2igan_torch.train.train_gan import CondGanTrainer


def local_batch(batch, mesh: DataMesh):
    """This rank's rows of every array of a global batch dict."""
    def rows(x):
        if isinstance(x, list):
            return [rows(v) for v in x]
        b = x.shape[0] // mesh.world
        return np.ascontiguousarray(x[mesh.rank * b:(mesh.rank + 1) * b])
    return {k: rows(v) for k, v in batch.items()}


def states(*modules):
    """Each module's state dict, detached copies."""
    return [{k: v.detach().clone() for k, v in m.state_dict().items()}
            for m in modules]


def batch_norm(mesh: DataMesh, x, w, weight, bias):
    """A train-mode :class:`BatchNorm` on this rank's rows of ``x`` inside
    ``global_batch_stats``, the objective ``sum(y * w)`` over the rows:
    the whole output and input gradient (gathered), the parameters'
    gradients summed over ranks and the running statistics."""
    bn = BatchNorm(x.shape[1])
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(weight))
        bn.bias.copy_(torch.as_tensor(bias))
    b = x.shape[0] // mesh.world
    rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
    xl = torch.as_tensor(x[rows]).clone().requires_grad_(True)
    with global_batch_stats(mesh):
        y = bn(xl, train=True)
    dx, dw, db = torch.autograd.grad((y * torch.as_tensor(w[rows])).sum(),
                                     [xl, bn.weight, bn.bias])
    bn.weight.grad, bn.bias.grad = dw, db
    mesh.all_reduce_grads_([bn.weight, bn.bias], divisor=1)
    return {"y": mesh.gather_rows(y), "dx": mesh.gather_rows(dx),
            "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            "running_mean": bn.running_mean, "running_var": bn.running_var}


def gan_state(cfg, clip_cfg, sd):
    clip = build_clip(clip_cfg)
    clip.load_state_dict(sd["clip"])
    gen = build_generator(cfg)
    gen.load_state_dict(sd["gen"])
    ds = build_discriminators(cfg)
    for d, s in zip(ds, sd["ds"]):
        d.load_state_dict(s)
    sgd = functools.partial(torch.optim.SGD, lr=1.0)
    return clip.requires_grad_(False), init_gan_state(cfg, gen, ds, sgd, sgd)


def gan_steps(mesh: DataMesh, cfg, clip_cfg, sd, batch, noise, steps=3):
    """One GAN step with SGD (lr 1) from ``sd`` on this rank's rows of
    ``batch`` with the given global ``noise``, then ``steps - 1`` more on
    the same batch with noise drawn from a seeded generator.  Returns the
    first step's metrics and state, the last state, and the K1/K2
    launches."""
    clip, state = gan_state(cfg, clip_cfg, sd)
    step = make_gan_step(cfg, clip, mesh=mesh)
    local = local_batch(batch, mesh)
    LAUNCHES.clear()
    metrics = step(state, local, *map(torch.as_tensor, noise))
    first = states(state.gen, state.gen_ema, *state.ds)
    draw = torch.Generator().manual_seed(7)
    for _ in range(steps - 1):
        step(state, local, generator=draw)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "first": first,
            "last": states(state.gen, state.gen_ema, *state.ds),
            "opt": [o.state_dict() for o in [state.g_opt, *state.d_opts]],
            "launches": dict(LAUNCHES)}


def damsm(mesh: DataMesh, cfg, clip_cfg, clip_sd, batch, steps_per_epoch):
    """The DAMSM loss and its gradient averaged over ranks (before any
    clip), then one DAMSM step with the real optimizer from the same
    weights."""
    def fresh():
        clip = build_clip(clip_cfg)
        clip.load_state_dict(clip_sd)
        return clip.requires_grad_(True)

    local = local_batch(batch, mesh)
    clip = fresh()
    total, metrics = make_damsm_loss(cfg, clip, mesh=mesh)(local)
    params = list(clip.parameters())
    for p, g in zip(params, torch.autograd.grad(total, params,
                                                allow_unused=True)):
        p.grad = g
    mesh.all_reduce_grads_(params)
    grads = {n: None if p.grad is None else p.grad.clone()
             for n, p in clip.named_parameters()}
    state = init_damsm_state(cfg, fresh(),
                             damsm_optimizer(cfg, steps_per_epoch))
    step_metrics = make_damsm_step(cfg, state.clip, state.opt,
                                   mesh=mesh)(local)
    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "grads": grads,
            "step_metrics": {k: float(v) for k, v in step_metrics.items()},
            "after": states(state.clip)[0],
            "adam": state.opt.adam.state_dict()}


def pngs(root):
    """Every file under ``root`` by its relative path, with its bytes."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def sweep(mesh: DataMesh, cfg, clip_cfg, out_dir):
    """One round of ``CondGanTrainer.sampling`` on the synthetic test
    split: (R mean, std) and the PNGs the run wrote (rank 0 reads them
    after the sweep's barrier)."""
    trainer = CondGanTrainer(cfg, "cpu", clip_cfg=clip_cfg, output_dir=out_dir,
                             split="test", mesh=mesh)
    r = trainer.sampling(num_rounds=1)
    return {"r": r, "pngs": pngs(os.path.join(out_dir, "valid", "single"))
            if mesh.rank == 0 else None}


def _stop_rank_at(trainer, rank: int, step: int) -> None:
    """SIGTERM to this process after ``step`` if it is rank ``rank``."""
    inner = trainer.step_fn

    def step_fn(*args, **kw):
        out = inner(*args, **kw)
        if trainer.mesh.rank == rank and trainer.state.step == step:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    trainer.step_fn = step_fn


def trainer_state(trainer):
    s = trainer.state
    return {"modules": states(s.gen, s.gen_ema, *s.ds),
            "opt": [o.state_dict() for o in [s.g_opt, *s.d_opts]],
            "step": s.step, "noise": trainer.noise.get_state(),
            "data_rng": trainer._data_rng}


def resume(mesh: DataMesh, cfg, clip_cfg, root, stop_at):
    """One epoch of ``CondGanTrainer.train`` straight through, and the
    same epoch stopped by a SIGTERM to rank 1 after step ``stop_at`` and
    finished by a fresh trainer resuming from the files."""
    whole = CondGanTrainer(cfg, "cpu", clip_cfg=clip_cfg,
                           output_dir=os.path.join(root, "whole"), mesh=mesh)
    whole.train(max_epochs=1)
    out = os.path.join(root, "stopped")
    first = CondGanTrainer(cfg, "cpu", clip_cfg=clip_cfg, output_dir=out,
                           mesh=mesh)
    _stop_rank_at(first, 1, stop_at)
    first.train(max_epochs=1)
    stopped = {"step": first.state.step, "epoch": first.epoch,
               "files": sorted(os.listdir(os.path.join(out, "Model")))}
    again = CondGanTrainer(cfg, "cpu", clip_cfg=clip_cfg, output_dir=out,
                           mesh=mesh)
    resumed_at = again.state.step
    again.train(max_epochs=1)
    return {"whole": trainer_state(whole), "resumed": trainer_state(again),
            "stopped": stopped, "resumed_at": resumed_at,
            "files": sorted(os.listdir(os.path.join(out, "Model")))}


def resume_step(mesh: DataMesh, cfg, clip_cfg, sd, out_dir, batch, noise,
                lr, hosts: bool = False, loader_epoch: int = 0,
                draws: int = 0):
    """A ``CondGanTrainer`` with SGD at ``lr`` (as the JAX references'
    optimizers) resumes the newest full state under ``out_dir`` (or starts
    from G, its EMA and the discriminators of ``sd``; CLIP always from
    ``sd["clip"]``), takes one GAN step on this rank's rows of the global
    ``batch`` with the global ``noise``, marks the data state
    (``loader_epoch``, and the dataset generator ``draws + rank`` draws
    on) and saves the full state.  With ``hosts`` every rank is a host of
    its own.  Returns what was resumed (step, data state) and the state
    after the step.  The trainer's ``init_gan_state`` is swapped for the
    rest of the process (a rank program's own; a test calling this in its
    own process restores it)."""
    if hosts:
        mesh = dataclasses.replace(mesh, host_index=mesh.rank,
                                   host_count=mesh.world, local_index=0,
                                   local_count=1)
    sgd = functools.partial(torch.optim.SGD, lr=lr)
    train_gan.init_gan_state = functools.partial(init_gan_state, g_tx=sgd,
                                                 d_tx=sgd)
    trainer = CondGanTrainer(cfg, "cpu", clip_cfg=clip_cfg,
                             output_dir=out_dir, mesh=mesh)
    trainer.clip.load_state_dict(sd["clip"])
    s = trainer.state
    if s.step == 0:
        s.gen.load_state_dict(sd["gen"])
        s.gen_ema.load_state_dict(sd["gen"])
        for d, d_sd in zip(s.ds, sd["ds"]):
            d.load_state_dict(d_sd)
    resumed = {"step": s.step, "loader_epoch": trainer.loader.epoch,
               "data_rng": data_rng_state(trainer.dataset)}
    metrics = trainer.step_fn(s, local_batch(batch, mesh),
                              *map(torch.as_tensor, noise))
    trainer.loader.epoch = loader_epoch
    trainer.dataset.rng.random(draws + mesh.rank)
    trainer._data_rng = data_rng_state(trainer.dataset)
    trainer.save_state()
    return {"resumed": resumed, "saved_rng": trainer._data_rng,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "after": states(s.gen, s.gen_ema, *s.ds)}


def damsm_trainer(mesh: DataMesh, cfg, clip_cfg, out_dir):
    """``DamsmTrainer``'s validation losses on its seeded weights, then
    one epoch of training: its last metrics, CLIP and files."""
    trainer = DamsmTrainer(cfg, out_dir, "cpu", clip_cfg=clip_cfg,
                           words_num=16, mesh=mesh)
    val = trainer.evaluate()
    metrics = trainer.train(max_epochs=1)
    return {"val": val, "metrics": metrics,
            "clip": states(trainer.state.clip)[0],
            "files": sorted(os.listdir(os.path.join(out_dir, "Model")))}


def tensor_parallel(mesh: DataMesh, cfg, clip_cfg, clip_sd, batch, model,
                    out_dir):
    """The DAMSM loss and gradients with CLIP sharded over ``model`` ranks
    and the batch over the rest, and the whole CLIP gathered back; whether
    ``save_clip_pth`` refused the sharded module (the gathered one is
    written to ``out_dir``)."""
    data, group = tp.mesh_2d(mesh, model)
    clip = build_clip(clip_cfg)
    clip.load_state_dict(clip_sd)
    tp.shard_clip_(clip.requires_grad_(True), group)
    total, metrics = make_damsm_loss(cfg, clip, mesh=data)(
        local_batch(batch, data))
    params = list(clip.parameters())
    for p, g in zip(params, torch.autograd.grad(total, params,
                                                allow_unused=True)):
        p.grad = g
    tp.all_reduce_grads_(clip, data)
    try:
        save_clip_pth(clip, os.path.join(out_dir, f"clip_{mesh.rank}.pth"))
        refused = False
    except ValueError:
        refused = True
    whole = tp.gather_clip(clip)
    save_clip_pth(whole, os.path.join(out_dir, f"whole_{mesh.rank}.pth"))
    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "refused": refused,
            "grads": {n: None if p.grad is None else p.grad.clone()
                      for n, p in clip.named_parameters()},
            "shapes": {n: tuple(p.shape) for n, p in clip.named_parameters()},
            "whole": states(whole)[0],
            "model_index": torch.distributed.get_rank(group)}


def fail_on_rank(mesh: DataMesh, rank):
    """Rank ``rank`` raises; the others (every rank when ``rank`` is None)
    sleep past any test's timeout."""
    if mesh.rank == rank:
        raise ValueError(f"rank {rank} gives up")
    time.sleep(600)


def run_all(mesh: DataMesh, jobs):
    """Run ``(label, function name, kwargs)`` jobs of this module in order
    on one process group; returns their results by label."""
    return {label: globals()[name](mesh, **kw) for label, name, kw in jobs}
