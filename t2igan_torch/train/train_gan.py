"""Conditional GAN trainer: the port's counterpart of
``t2igan.train.train_gan.CondGanTrainer`` (train with snapshots, resume,
the generation + R-precision sweep and caption-driven generation).

    python -m t2igan_torch.train_gan --cfg t2igan_torch/configs/clip_bird_dmgan.yml \
        --steps N [--batch B] [--dtype bf16|f32] [--device cuda|cpu] [--seed S]

takes ``--steps`` adversarial steps and writes nothing;
``python -m t2igan_torch.main`` is the full entry point (epochs with
checkpoints, ``B_VALIDATION`` sampling, ``gen_example``).

The trainer builds CLIP (from ``TRAIN.CLIP_MODEL_CHECKPOINT`` when that
names an existing ``clip%d.pth``), the generator and one discriminator per
pyramid size with random weights from ``seed``, and the data of ``split``
(:func:`t2igan_torch.train.pretrain_damsm.make_dataset`: the reference's
dataset under ``DATA_DIR``, else the synthetic one) behind the JAX
trainer's loader (:class:`t2igan_torch.data.pipeline.DataLoader`: shuffled
when ``TRAIN.FLAG``, ``WORKERS`` workers, ``DATA_ENGINE``), whose batches
reach the card from pinned memory ahead of the step.  CLIP stays frozen.
``TRAIN.NET_G`` resumes it:

* a ``.npz`` (the JAX package's generator export) or a
  ``netG_epoch_%d.pth`` sets G and its EMA to the file's weights (as
  distinct tensors), and with ``TRAIN.B_NET_D`` each sibling
  ``netD%d.pth`` fills its discriminator; training goes on at the epoch
  after the one in the file's name;
* a directory, or an empty ``NET_G`` with an ``output_dir``, restores the
  newest full train state in it (``Model/state_<step>.pt``,
  :mod:`t2igan_torch.train.checkpoint`); saved under another host count,
  only its model and optimizer state and epochs done are restored
  (:func:`t2igan_torch.train.pretrain_damsm.same_host_count`);
* otherwise the seeded weights stay, and the trainer says so.

Every weight load copies into the existing tensors (``copy_`` or
``load_state_dict``), never rebinds ``.data``: the fused tail keys its
laid-out operands on each tensor's ``(data_ptr, _version)``, and a rebound
tensor could leave it sampling with stale operands.  On a card the step
replays CUDA graphs that read and write the train state where it lies
(:mod:`t2igan_torch.train.graphs`); a rebound tensor, or a resume that
loads the optimizers' state, drops them and the step captures again.

The default device is ``cuda``; without a card this raises rather than
falling back to the CPU.

Under ``torchrun`` (``python -m torch.distributed.run --nproc_per_node N
-m t2igan_torch.train_gan ...``, or ``-m t2igan_torch.main``) the trainer
is data-parallel (:mod:`t2igan_torch.parallel.mesh`): one rank a card
(``cuda:LOCAL_RANK``, NCCL; gloo with ``--device cpu``), ``TRAIN.BATCH_SIZE``
per host split over the host's ranks, and the step of the JAX trainer on
the global batch of ``BATCH_SIZE`` times the hosts.  Every rank resumes
from the same files; rank 0 alone writes them (a barrier follows each
write), except the sweep's PNGs, which each rank writes for its own rows.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from t2igan_torch.config import Config, cfg_from_file, cfg_replace
from t2igan_torch.data.pipeline import Batch, prefetch_to_device
from t2igan_torch.data.tokenizer import ClipTokenizer
from t2igan_torch.generate import sample_and_write
from t2igan_torch.evaluation.rprecision import (MisCaptionBank,
                                                bootstrap_r_precision,
                                                make_rank_fn)
from t2igan_torch.models.clip import ClipConfig
from t2igan_torch.models.convert import (load_discriminator_pth,
                                         save_discriminator_pth,
                                         save_generator_pth)
from t2igan_torch.models.discriminator import init_discriminator_
from t2igan_torch.models.factory import (build_discriminators,
                                         build_generator, load_clip)
from t2igan_torch.models.generator import init_generator_
from t2igan_torch.ops.image import resize_nearest, uint8_from_tanh
from t2igan_torch.ops.kernels import LAUNCHES
from t2igan_torch.parallel.mesh import DataMesh, init_distributed
from t2igan_torch.train.checkpoint import (CheckpointManager,
                                           GracefulShutdown, gan_payload,
                                           parse_epoch_from_path,
                                           restore_gan_payload)
from t2igan_torch.train.export import load_generator_weights
from t2igan_torch.train.pretrain_damsm import (data_rng_state, make_dataset,
                                               make_loader, same_host_count,
                                               set_data_rng_state)
from t2igan_torch.train.state import init_gan_state
from t2igan_torch.train.steps import make_gan_step, make_sampler
from t2igan_torch.utils.logging import MetricsLogger, StepTimer
from t2igan_torch.utils.png import write_png
from t2igan_torch.utils.viz import (attention_grid, save_image_grid,
                                    tanh_to01, word_labels)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}

# (z [b, Z_DIM], eps [b, CONDITION_DIM]) for a batch of b.
NoiseFn = Callable[[int], Tuple[torch.Tensor, torch.Tensor]]


class CondGanTrainer:
    """Models, train state and data of adversarial training and its
    evaluation.

    ``dtype`` is the precision of the forwards (parameters stay f32; the
    sampler runs on ``dtype`` copies of the EMA G and CLIP); ``clip_cfg``
    the CLIP widths (ViT-B/32 by default); ``output_dir`` where
    snapshots, samples and the sweep's images go (``None``: nowhere, and
    no resume from it).  ``mesh`` is the data-parallel layout (default
    :func:`init_distributed` on ``device``: a single process without a
    ``torchrun`` environment); a rank it leaves out
    (:meth:`DataMesh.for_batch`) takes no step and writes nothing."""

    def __init__(self, cfg: Config, device: str = "cuda",
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 clip_cfg: ClipConfig = ClipConfig(),
                 output_dir: Optional[str] = None, split: str = "train",
                 mesh: Optional[DataMesh] = None):
        if torch.device(device).type == "cuda" and \
                not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: t2igan_torch.train_gan runs "
                               "on the card by default; pass --device cpu "
                               "to run on the CPU")
        self.mesh = mesh = (mesh or init_distributed(device)).for_batch(
            cfg.TRAIN.BATCH_SIZE)
        dev = mesh.device
        self.cfg = cfg
        self.dtype = dtype
        self.output_dir = output_dir
        self.device = dev
        self.tokenizer = ClipTokenizer.load(cfg.DATA_DIR or None)
        self.dataset = make_dataset(cfg, split)
        self.loader = make_loader(cfg, self.dataset, self.tokenizer,
                                  cfg.TEXT.WORDS_NUM, cfg.TRAIN.FLAG, dev,
                                  mesh)
        rng = torch.Generator().manual_seed(seed)
        self.clip = load_clip(cfg, clip_cfg, rng).requires_grad_(False).to(
            dev)
        gen = init_generator_(build_generator(cfg), rng).train()
        ds = [init_discriminator_(d, rng).train()
              for d in build_discriminators(cfg)]
        gen = gen.to(dev, memory_format=torch.channels_last)
        ds = [d.to(dev, memory_format=torch.channels_last) for d in ds]
        mesh.replicate_([self.clip, gen, *ds])
        self.state = init_gan_state(cfg, gen, ds)
        # GDCGan does not train (make_gan_step raises, as the JAX step
        # fails); under GAN.B_DCGAN the trainer only evaluates.
        self.step_fn = None if cfg.GAN.B_DCGAN and not cfg.TRAIN.FLAG \
            else make_gan_step(cfg, self.clip, dtype, mesh)
        self.noise = torch.Generator(device=dev).manual_seed(seed + 1)
        self.epoch = 0  # epochs done: train() goes on from here
        # (permutation, batches done) of an epoch stopped part-way.
        self._epoch_left: Optional[Tuple[np.ndarray, int]] = None
        # The dataset generator's state after the last batch trained on.
        self._data_rng = data_rng_state(self.dataset)
        self._eval_clip = self._eval_gen = None
        self._mis_bank: Optional[MisCaptionBank] = None
        self._resume()

    # ------------------------------------------------------------ resume --

    def _resume(self) -> None:
        cfg, state = self.cfg, self.state
        net_g = cfg.TRAIN.NET_G
        if net_g and os.path.isfile(net_g) and net_g.endswith(
                (".npz", ".pth")):
            load_generator_weights(state.gen, net_g)
            print(f"Loaded generator weights: {net_g}")
            # G and its EMA start equal, as distinct tensors.
            state.gen_ema.load_state_dict(state.gen.state_dict())
            self.epoch = parse_epoch_from_path(net_g) + 1
            if cfg.TRAIN.B_NET_D:
                for i, d in enumerate(state.ds):
                    path = os.path.join(os.path.dirname(net_g),
                                        f"netD{i}.pth")
                    if os.path.isfile(path):
                        load_discriminator_pth(d, path)
                        print(f"Loaded torch discriminator: {path}")
            return
        resume_dir = net_g or (self.output_dir and self._out("Model"))
        if resume_dir and os.path.isdir(resume_dir):
            payload, step = CheckpointManager(resume_dir).restore()
            if payload is not None:
                saved = restore_gan_payload(state, payload, self.noise)
                self.epoch = saved["epoch"]
                by_host = payload.get("data_rng_by_host",
                                      [saved["data_rng"]])
                if same_host_count(by_host, self.mesh):
                    self._epoch_left = saved["epoch_left"]
                    self.loader.epoch = saved["loader_epoch"]
                    self._data_rng = by_host[self.mesh.host_index]
                    set_data_rng_state(self.dataset, self._data_rng)
                print(f"Resumed GAN state from step {step} ({self.epoch} "
                      f"epochs done) in {resume_dir}")
                return
        where = f"TRAIN.NET_G {net_g!r} names no checkpoint" if net_g \
            else "no checkpoint to resume"
        print(f"NOTE: {where}; keeping the seeded weights.")

    # -------------------------------------------------------------- data --

    def device_batches(self, batches: Iterator[Batch]
                       ) -> Iterator[Dict[str, Any]]:
        """Loader batches as the train step's dicts on the trainer's
        device, two ahead of the step; each keeps its batch's dataset
        generator state under ``rng_state``."""
        return prefetch_to_device(
            (dict(b.arrays(), rng_state=b.rng_state) for b in batches),
            self.device)

    def batches(self) -> Iterator[Dict[str, Any]]:
        """The loader's batches on the device, epoch after epoch."""
        while True:
            yield from self.device_batches(iter(self.loader))

    def _out(self, *parts: str) -> str:
        if self.output_dir is None:
            raise ValueError("this writes files: give the trainer an "
                             "output_dir")
        return os.path.join(self.output_dir, *parts)

    # ---------------------------------------------------------- training --

    def train_steps(self, steps: int) -> Dict[str, float]:
        """Take ``steps`` steps on a fresh shuffled stream, with one printed
        line each, and write nothing; returns the last step's metrics."""
        self._check_trainable()
        metrics: Dict[str, float] = {}
        if not self.mesh.takes_part:
            return metrics
        batches = self.batches()
        for _ in range(steps):
            t0 = time.perf_counter()
            batch = next(batches)
            out = self.step_fn(self.state, batch, generator=self.noise)
            self._data_rng = batch["rng_state"]
            metrics = {k: float(v) for k, v in out.items()}
            if self.mesh.rank == 0:
                print(f"[{self.state.step}] Loss_D: "
                      f"{self._d_loss(metrics):.4f} "
                      f"Loss_G: {metrics['g_loss']:.4f} "
                      f"Time: {time.perf_counter() - t0:.2f}s", flush=True)
        return metrics

    def _check_trainable(self) -> None:
        if self.step_fn is None:
            make_gan_step(self.cfg, self.clip)  # raises on GAN.B_DCGAN

    def _d_loss(self, metrics: Dict[str, float]) -> float:
        return sum(metrics[f"d_loss{i}"] for i in range(len(self.state.ds)))

    def train(self, max_epochs: Optional[int] = None) -> Dict[str, float]:
        """Epochs ``self.epoch`` .. ``max_epochs - 1`` (default
        ``TRAIN.MAX_EPOCH``) of shuffled batches, one line per epoch.
        Every ``TRAIN.SNAPSHOT_INTERVAL`` epochs and after the last it
        writes the full train state, ``Model/netG_epoch_%d.pth`` (the EMA
        weights with G's running statistics), ``Model/netD%d.pth`` and
        ``Image/G_%d.png`` with its attention figure ``G_%d_attn.png``.
        Every step is a row of ``metrics.jsonl`` (:class:`MetricsLogger`,
        a console line every 100 steps, ``images_per_sec`` from a
        :class:`StepTimer`), as in the JAX trainer.  SIGTERM or SIGINT
        ends the step under way, saves the full state with the epoch's
        permutation and the batches done, and returns; a resumed run takes
        the rest of that epoch.  Returns the last step's metrics."""
        self._check_trainable()
        epochs = max_epochs if max_epochs is not None else \
            self.cfg.TRAIN.MAX_EPOCH
        metrics: Dict[str, float] = {}
        if not self.mesh.takes_part:
            return metrics
        logger = MetricsLogger(self._out(), print_every=100) \
            if self.mesh.writes else None
        timer = StepTimer(self.cfg.TRAIN.BATCH_SIZE * self.mesh.host_count)
        stop = GracefulShutdown()
        try:
            for epoch in range(self.epoch, epochs):
                start = time.perf_counter()
                perm, done = self._epoch_left or (self.loader.next_order(),
                                                  0)
                self._epoch_left = None
                out = {}
                for i, batch in enumerate(self.device_batches(
                        self.loader.batches(perm, done)), done):
                    out = self.step_fn(self.state, batch,
                                       generator=self.noise)
                    timer.tick()
                    if logger is not None:
                        logger.log(self.state.step, dict(
                            out, images_per_sec=timer.images_per_sec))
                    self._data_rng = batch["rng_state"]
                    # Every rank stops at the same step: one that stopped
                    # alone would leave the others in a collective.
                    if self.mesh.any_rank(stop.requested):
                        stop.requested = True
                        self._epoch_left = (perm, i + 1)
                        break
                if logger is not None:
                    logger.flush()
                metrics = {k: float(v) for k, v in out.items()}
                if metrics and self.mesh.rank == 0:
                    print(f"[{epoch}/{epochs}] Loss_D: "
                          f"{self._d_loss(metrics):.2f} Loss_G: "
                          f"{metrics['g_loss']:.2f} Time: "
                          f"{time.perf_counter() - start:.2f}s", flush=True)
                if stop.requested:
                    if self.mesh.rank == 0:
                        print("Shutdown requested: checkpointing and "
                              "exiting.")
                    self.save_state()
                    break
                self.epoch = epoch + 1
                if epoch % self.cfg.TRAIN.SNAPSHOT_INTERVAL == 0 or \
                        epoch == epochs - 1:
                    self.snapshot(epoch)
        finally:
            stop.restore()
            if logger is not None:
                logger.close()
        return metrics

    def save_state(self) -> Optional[str]:
        """Write the full train state under ``Model/`` (rank 0; under data
        parallelism with each host's dataset generator state); returns its
        path (None on the other ranks)."""
        by_host = self.mesh.by_host(self._data_rng)
        path = None
        if self.mesh.writes:
            payload = gan_payload(self.state, self.epoch, self.noise,
                                  self.loader.epoch, by_host[0],
                                  self._epoch_left)
            if self.mesh.distributed:
                payload["data_rng_by_host"] = by_host
            path = CheckpointManager(self._out("Model")).save(
                self.state.step, payload)
        self.mesh.barrier()
        return path

    def snapshot(self, epoch: int) -> None:
        """The full state, ``netG_epoch_<epoch>.pth``, ``netD%d.pth`` and
        the sample sheet ``Image/G_<epoch>.png`` (rank 0)."""
        self.save_state()
        if self.mesh.writes:
            save_generator_pth(self.state.gen_ema,
                               self._out("Model", f"netG_epoch_{epoch}.pth"),
                               stats_from=self.state.gen)
            for i, d in enumerate(self.state.ds):
                save_discriminator_pth(d, self._out("Model", f"netD{i}.pth"))
            self._save_sample_grid(epoch)
        self.mesh.barrier()

    def _save_sample_grid(self, tag, z: Optional[torch.Tensor] = None
                          ) -> None:
        """The finest images of the EMA G on the loader's probe batch
        (``peek``: the first ``BATCH_SIZE`` records in dataset order, their
        first captions; no pixel is read and no stream moves), with fixed
        noise (``z``, by default from a generator seeded 42; zero
        ``eps``), as one sheet ``Image/G_<tag>.png``, and the first 8 of
        them under the
        last stage's attention maps of their words 1-8 as
        ``Image/G_<tag>_attn.png`` (:func:`attention_grid`).  The sampler
        returns the maps, so its memory read runs as einsums, not K1, as
        the JAX trainer's does."""
        batch = self.loader.peek(with_images=False, whole=True)
        if batch is None:
            return
        n = len(batch.keys)
        if z is None:
            z = torch.randn((n, self.cfg.GAN.Z_DIM),
                            generator=torch.Generator().manual_seed(42))
        eps = torch.zeros((n, self.cfg.GAN.CONDITION_DIM))
        fakes, atts = make_sampler(self.cfg, *self.eval_models(),
                                   return_attn=True)(
            batch.input_ids, batch.attention_mask, z, eps)
        finest = tanh_to01(fakes[-1].float().cpu().numpy())
        save_image_grid(finest, self._out("Image", f"G_{tag}.png"))
        if atts:
            m = min(n, 8)  # overlay sheet stays readable
            grid = attention_grid(finest[:m], atts[-1][:m].cpu().numpy(),
                                  word_labels(self.tokenizer,
                                              batch.input_ids[:m]))
            write_png(self._out("Image", f"G_{tag}_attn.png"), grid)

    # -------------------------------------------------------- evaluation --

    def eval_models(self, use_ema: bool = True):
        """(CLIP, G) for sampling, in eval mode in the trainer's dtype: the
        modules themselves in f32; otherwise copies in ``dtype``, whose
        G is refilled from the EMA (or the trained G) with
        ``load_state_dict`` at every call."""
        src = self.state.gen_ema if use_ema else self.state.gen
        if self.dtype == torch.float32:
            return self.clip.eval(), src
        if self._eval_clip is None:
            self._eval_clip = copy.deepcopy(self.clip).to(self.dtype).eval()
        if self._eval_gen is None:
            self._eval_gen = copy.deepcopy(src).requires_grad_(False).to(
                self.dtype)
        else:
            self._eval_gen.load_state_dict(src.state_dict())
        return self._eval_clip, self._eval_gen

    def sweep_words(self, clip) -> int:
        """Tokens per caption in the R-precision ranking: 77, or the CLIP's
        positions when it has fewer."""
        return min(77, clip.cfg.max_positions)

    def mis_caption_bank(self, words_num: int) -> MisCaptionBank:
        """The split's captions tokenized once; kept across sweeps, so its
        draws go on where the last sweep left them, as in the JAX
        package."""
        if self._mis_bank is None or self._mis_bank.words_num != words_num:
            self._mis_bank = MisCaptionBank(self.dataset, self.tokenizer,
                                            words_num)
        return self._mis_bank

    def sampling(self, split_dir: str = "valid", num_rounds: int = 11,
                 r_target: int = 30000, save_images: bool = True,
                 use_ema: bool = True, n_mis: int = 99,
                 noise: Optional[NoiseFn] = None) -> Tuple[float, float]:
        """The generation + R-precision sweep: ``num_rounds`` passes over
        the loader's batches (an epoch each, in its order, a last partial
        batch dropped), their captions drawn as iterating the loader draws
        them, without reading pixels.  Each batch is sampled with ``z`` and
        ``eps`` from
        ``noise(b)`` (default: a generator seeded 100, ``z`` then ``eps``),
        its finest images are written as
        ``<output_dir>/<split_dir>/single/<key>_<round>.png`` (truncating
        to uint8 as the JAX package does), resized 256 -> CLIP size
        (nearest-exact) and ranked against their true and ``n_mis`` other
        captions.  At ``r_target`` ranked images it stops; it prints ``R
        mean:... std:...`` and returns (mean, std) of
        :func:`bootstrap_r_precision`.

        Under data parallelism each rank samples, writes and ranks its
        rows of every batch; the noise and the mis-captions are drawn for
        the global batch on every rank (each rank takes its rows), and the
        hits are gathered in global order, so R is the one-rank sweep's.
        A rank left out returns (nan, nan).  The hits stay on the trainer
        as ``sweep_hits``."""
        cfg = self.cfg
        mesh = self.mesh
        if not mesh.takes_part:
            return float("nan"), float("nan")
        clip, gen = self.eval_models(use_ema)
        sampler = make_sampler(cfg, clip, gen)
        rank = make_rank_fn(clip)
        bank = self.mis_caption_bank(self.sweep_words(clip))
        if noise is None:
            draw = torch.Generator().manual_seed(100)

            def noise(b):
                return (torch.randn((b, cfg.GAN.Z_DIM), generator=draw),
                        torch.randn((b, cfg.GAN.CONDITION_DIM),
                                    generator=draw))

        save_dir = self._out(split_dir, "single") if save_images else None
        hits: List[bool] = []
        # PNG encodes run on IO threads; leaving the block joins them.
        with ThreadPoolExecutor(4) as io_pool:
            for round_i in range(num_rounds):
                for batch in self.loader.caption_batches():
                    b = len(batch.keys)
                    z, eps = map(mesh.local_rows, noise(b * mesh.world))
                    finest = sampler(batch.input_ids, batch.attention_mask,
                                     z, eps)[-1]
                    if save_images:
                        u8 = uint8_from_tanh(finest).cpu().numpy()
                        for j, key in enumerate(batch.keys):
                            io_pool.submit(write_png, os.path.join(
                                save_dir, f"{key}_{round_i}.png"), u8[j])
                    cls = mesh.gather_rows(torch.as_tensor(
                        batch.class_ids, device=self.device)).cpu().numpy()
                    mis_ids, mis_mask = (x[mesh.row_range(b)]
                                         for x in bank.sample(cls, n_mis))
                    # A whole batch, so the resized images start aligned
                    # for the bf16 kernels (ROADMAP F11).
                    resized = resize_nearest(
                        finest, clip.cfg.image_size).contiguous()
                    flags, _ = rank(resized, batch.input_ids,
                                    batch.attention_mask, mis_ids, mis_mask)
                    hits.extend(mesh.gather_rows(flags).cpu().tolist())
                    if len(hits) >= r_target:
                        break
                if len(hits) >= r_target:
                    break
        mesh.barrier()  # every rank's PNGs are written
        self.sweep_hits = hits
        mean, std = (bootstrap_r_precision(np.asarray(hits)) if hits
                     else (float("nan"), float("nan")))
        if mesh.rank == 0:
            print(f"R mean:{mean:.4f} std:{std:.4f}"
                  + ("" if len(hits) >= r_target else f" (n={len(hits)})"))
        return mean, std

    def gen_example(self, captions_by_key: Dict[str, List[str]],
                    n_samples: int = 1) -> None:
        """Images of the EMA G for user captions (``{name: [caption,
        ...]}``, as ``main.load_example_captions`` builds it): each
        stage's images as ``<output_dir>/<name>/<s>_s_<j>_g<k>.png`` for
        sample ``s``, caption ``j`` and stage ``k``, and stage ``k``'s
        attention maps over stage ``k + 1``'s images as
        ``<s>_a<k>.png`` (:func:`attention_grid`), noise from a generator
        seeded 0.  ``GAN.B_DCGAN`` raises ``NotImplementedError`` before
        writing anything: the JAX trainer's loop reads an image of the
        next stage for each map, which ``GDCGan`` (one image, a map per
        refinement stage) does not have, so it fails there."""
        if self.cfg.GAN.B_DCGAN:
            raise NotImplementedError(
                "gen_example with GAN.B_DCGAN: the JAX trainer's gen_example "
                "fails on GDCGan too (it pairs attention map k with image "
                "k + 1, and GDCGan gives one image); ROADMAP.md F20")
        if not self.mesh.writes:  # rank 0 renders them
            self.mesh.barrier()
            return
        sampler = make_sampler(self.cfg, *self.eval_models(),
                               return_attn=True)
        draw = torch.Generator().manual_seed(0)
        for key, captions in captions_by_key.items():
            for s in range(n_samples):
                sample_and_write(self.cfg, sampler, self.tokenizer, captions,
                                 draw, self._out(key),
                                 lambda j, k, s=s: f"{s}_s_{j}_g{k}.png",
                                 lambda k, s=s: f"{s}_a{k}.png")
        self.mesh.barrier()


def main(argv: Optional[Sequence[str]] = None,
         clip_cfg: ClipConfig = ClipConfig()) -> CondGanTrainer:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cfg", required=True, help="YAML config")
    p.add_argument("--steps", type=int, required=True)
    p.add_argument("--batch", type=int, default=None,
                   help="batch size (default TRAIN.BATCH_SIZE)")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="f32")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    cfg = cfg_from_file(args.cfg)
    if args.batch:
        cfg = cfg_replace(cfg, TRAIN={"BATCH_SIZE": args.batch})
    trainer = CondGanTrainer(cfg, args.device, DTYPES[args.dtype], args.seed,
                             clip_cfg)
    trainer.train_steps(args.steps)
    if trainer.device.type == "cuda" and trainer.mesh.rank == 0:
        print("kernel launches: " + json.dumps(dict(sorted(
            LAUNCHES.items()))), flush=True)
    return trainer
