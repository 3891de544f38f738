"""DAMSM CLIP fine-tuning: the port's counterpart of
``t2igan.train.pretrain_damsm.DamsmTrainer`` and of the root
``pretrain_DAMSM.py``.

    python -m t2igan_torch.pretrain_damsm --cfg t2igan_torch/configs/damsm/bird.yml \
        [--max_epochs N] [--batch B] [--output_dir D] [--dtype bf16|f32] \
        [--device cuda|cpu] [--seed S]

It builds CLIP (``TRAIN.CLIP_MODEL_CHECKPOINT`` when that names an existing
``.pth``, else random weights from ``--seed``) and the two-group
optimizer, takes one DAMSM step
(:func:`t2igan_torch.train.steps.make_damsm_step`) per batch with one
printed line each, validates at the end of every epoch, and writes
``<output_dir>/Model/clip%d.pth`` (the reference's names, which the JAX
package's ``load_torch_clip`` and the port's GAN trainer read) and the
full train state ``<output_dir>/Model/state_<step>.pt`` (CLIP, both Adam
groups, the update count, both loaders' epochs and their datasets'
generators) every ``TRAIN.SNAPSHOT_INTERVAL`` epochs and after the last.
A trainer whose ``<output_dir>/Model`` holds a full state resumes from the
newest, as the JAX trainer restores its orbax state.  Captions are 30
tokens a view.  The default device is ``cuda``; without a card this raises
rather than falling back to the CPU.

Data: ``DATA_DIR/train`` and ``DATA_DIR/val`` on disk are read as the
reference's datasets (:class:`t2igan_torch.data.dataset.TextImageDataset`,
the finest pyramid branch at ``TREE.BASE_SIZE``), through
:class:`t2igan_torch.data.pipeline.DataLoader` with ``WORKERS`` workers and
``DATA_ENGINE``; a split that is not on disk is the synthetic dataset, as
in the JAX package.  Every step is a row of ``<output_dir>/metrics.jsonl``
(:class:`t2igan_torch.utils.logging.MetricsLogger`), and every snapshot
epoch writes the attention figure ``<output_dir>/Image/attn_epoch%d.png``,
as the JAX trainer does.

Under ``torchrun`` (``python -m torch.distributed.run --nproc_per_node N
-m t2igan_torch.pretrain_damsm ...``) the trainer is data-parallel
(:mod:`t2igan_torch.parallel.mesh`): ``TRAIN.BATCH_SIZE`` per host split
over its ranks, the step's losses over the global batch, gradients
averaged before the update, validation split the same way; rank 0 alone
writes the files.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from t2igan_torch.config import Config, cfg_from_file, cfg_replace
from t2igan_torch.data.dataset import TextImageDataset
from t2igan_torch.data.pipeline import (DataLoader, prefetch_to_device,
                                        put_batch)
from t2igan_torch.data.synthetic import SyntheticDataset
from t2igan_torch.data.tokenizer import ClipTokenizer
from t2igan_torch.models.clip import ClipConfig
from t2igan_torch.models.convert import save_clip_pth
from t2igan_torch.losses import strip_special_tokens
from t2igan_torch.models.factory import load_clip
from t2igan_torch.ops.attention import word_region_attention
from t2igan_torch.parallel.mesh import DataMesh, init_distributed
from t2igan_torch.train.checkpoint import (CheckpointManager, damsm_payload,
                                           restore_damsm_payload)
from t2igan_torch.train.state import damsm_optimizer, init_damsm_state
from t2igan_torch.train.steps import make_damsm_loss, make_damsm_step
from t2igan_torch.utils.logging import MetricsLogger, StepTimer
from t2igan_torch.utils.png import write_png
from t2igan_torch.utils.viz import (attention_grid, denormalize_clip,
                                    word_labels)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}

# The reference tokenises DAMSM captions to 30 tokens
# (pretrain_DAMSM.py:103).
DAMSM_WORDS_NUM = 30


def make_dataset(cfg: Config, split: str
                 ) -> Union[TextImageDataset, SyntheticDataset]:
    """The reference's dataset when ``DATA_DIR/<split>`` is on disk, else
    the synthetic dataset of ``max(2 * TRAIN.BATCH_SIZE, 64)`` records (so
    smoke runs work without CUB or COCO), as the JAX package chooses."""
    split_dir = os.path.join(cfg.DATA_DIR, split)
    if cfg.DATA_DIR and os.path.isdir(split_dir):
        return TextImageDataset(cfg, split)
    print(f"WARNING: dataset split {split_dir!r} not found; "
          "using synthetic data.")
    return SyntheticDataset(cfg, size=max(2 * cfg.TRAIN.BATCH_SIZE, 64))


def make_loader(cfg: Config, dataset, tokenizer: ClipTokenizer,
                words_num: int, shuffle: bool, device: torch.device,
                mesh: Optional[DataMesh] = None) -> DataLoader:
    """The JAX trainers' loader: ``TRAIN.BATCH_SIZE``, ``max(1, WORKERS)``
    workers, ``DATA_ENGINE``; images in pinned memory for a card; split
    over ``mesh``'s hosts and local ranks (a rank the mesh leaves out gets
    its host's whole batches, and never reads them)."""
    split = {}
    if mesh is not None:
        split = dict(host_index=mesh.host_index, host_count=mesh.host_count)
        if mesh.takes_part:
            split.update(local_index=mesh.local_index,
                         local_count=mesh.local_count)
    return DataLoader(dataset, tokenizer, cfg.TRAIN.BATCH_SIZE, words_num,
                      shuffle=shuffle, num_workers=max(1, cfg.WORKERS),
                      engine=cfg.DATA_ENGINE,
                      pin_memory=device.type == "cuda", **split)


def data_rng_state(dataset):
    rng = getattr(dataset, "rng", None)
    return None if rng is None else rng.bit_generator.state


def set_data_rng_state(dataset, state) -> None:
    if state is not None:
        dataset.rng.bit_generator.state = state


class DamsmTrainer:
    """CLIP, its optimizer and the data of DAMSM fine-tuning.

    ``dtype`` is the precision of the towers (parameters and optimizer
    state stay f32); ``clip_cfg`` the CLIP widths (ViT-B/32 by default);
    ``mesh`` the data-parallel layout (default :func:`init_distributed`
    on ``device``); a rank it leaves out trains on nothing and writes
    nothing."""

    def __init__(self, cfg: Config, output_dir: str, device: str = "cuda",
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 clip_cfg: ClipConfig = ClipConfig(),
                 words_num: int = DAMSM_WORDS_NUM,
                 mesh: Optional[DataMesh] = None):
        if torch.device(device).type == "cuda" and \
                not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: t2igan_torch.pretrain_damsm "
                               "runs on the card by default; pass --device "
                               "cpu to run on the CPU")
        self.mesh = mesh = (mesh or init_distributed(device)).for_batch(
            cfg.TRAIN.BATCH_SIZE)
        dev = mesh.device
        self.cfg = cfg
        self.output_dir = output_dir
        self.device = dev
        os.makedirs(output_dir, exist_ok=True)
        self.tokenizer = tokenizer = ClipTokenizer.load(cfg.DATA_DIR or None)
        self.train_batches, self.val_batches = (
            make_loader(cfg, make_dataset(cfg, split), tokenizer, words_num,
                        True, dev, mesh) for split in ("train", "val"))
        rng = torch.Generator().manual_seed(seed)
        clip = load_clip(cfg, clip_cfg, rng).to(dev)
        mesh.replicate_([clip])
        self.tx = damsm_optimizer(cfg, steps_per_epoch=len(self.train_batches))
        self.state = init_damsm_state(cfg, clip, self.tx)
        self.step_fn = make_damsm_step(cfg, clip, self.state.opt, dtype, mesh)
        self.eval_loss_fn = make_damsm_loss(cfg, clip, dtype, mesh)
        self.epoch = 0  # epochs done: train() goes on from here
        self.ckpt = CheckpointManager(os.path.join(output_dir, "Model"))
        payload, step = self.ckpt.restore()
        if payload is not None:
            self.epoch = restore_damsm_payload(self.state, payload)
            self.train_batches.epoch = payload["train_order"]
            self.val_batches.epoch = payload["val_order"]
            h = mesh.host_index
            for loader, key in ((self.train_batches, "train_rng"),
                                (self.val_batches, "val_rng")):
                set_data_rng_state(loader.dataset, payload.get(
                    key + "_by_host", [payload.get(key)])[h])
            print(f"Resumed DAMSM state from step {step} ({self.epoch} "
                  f"epochs done)")

    def checkpoint_path(self, epoch: int) -> str:
        return os.path.join(self.output_dir, "Model", f"clip{epoch}.pth")

    def train(self, max_epochs: Optional[int] = None) -> Dict[str, float]:
        """Epochs ``self.epoch`` .. ``max_epochs - 1`` (default
        ``TRAIN.MAX_EPOCH``) of one step per batch, each followed by
        :meth:`evaluate` and, every ``TRAIN.SNAPSHOT_INTERVAL`` epochs and
        after the last, a ``clip%d.pth``, the full train state and
        :meth:`save_attention_figure`.  Each step is a row of
        ``metrics.jsonl`` (a console line every 50 steps,
        ``images_per_sec`` from a :class:`StepTimer`).  Returns the last
        step's metrics."""
        cfg = self.cfg
        epochs = max_epochs if max_epochs is not None else cfg.TRAIN.MAX_EPOCH
        metrics: Dict[str, float] = {}
        mesh = self.mesh
        if not mesh.takes_part:
            return metrics
        logger = MetricsLogger(self.output_dir) if mesh.writes else None
        timer = StepTimer(cfg.TRAIN.BATCH_SIZE * mesh.host_count)
        try:
            for epoch in range(self.epoch, epochs):
                start = time.perf_counter()
                metrics = self.train_epoch(epoch, logger, timer) or metrics
                if logger is not None:
                    logger.flush()
                val = self.evaluate()
                if mesh.rank == 0:
                    print(f"| end epoch {epoch:3d} | valid s_loss "
                          f"{val['s_loss']:5.2f} w_loss "
                          f"{val['w_loss']:5.2f} |"
                          f" {time.perf_counter() - start:.1f}s", flush=True)
                self.epoch = epoch + 1
                if epoch % cfg.TRAIN.SNAPSHOT_INTERVAL == 0 or \
                        epoch == epochs - 1:
                    self.snapshot(epoch)
        finally:
            if logger is not None:
                logger.close()
        return metrics

    def snapshot(self, epoch: int) -> None:
        """``clip<epoch>.pth``, the full train state (under data
        parallelism with each host's dataset generator states) and the
        attention figure, written by rank 0; a barrier follows."""
        mesh = self.mesh
        rngs = {key: mesh.by_host(data_rng_state(loader.dataset))
                for loader, key in ((self.train_batches, "train_rng"),
                                    (self.val_batches, "val_rng"))}
        if mesh.writes:
            save_clip_pth(self.state.clip, self.checkpoint_path(epoch))
            payload = dict(damsm_payload(self.state, self.epoch),
                           train_order=self.train_batches.epoch,
                           val_order=self.val_batches.epoch,
                           train_rng=rngs["train_rng"][0],
                           val_rng=rngs["val_rng"][0])
            if mesh.distributed:
                payload.update({k + "_by_host": v for k, v in rngs.items()})
            self.ckpt.save(self.state.step, payload)
            self.save_attention_figure(epoch)
        mesh.barrier()

    def train_epoch(self, epoch: int, logger: Optional[MetricsLogger] = None,
                    timer: Optional[StepTimer] = None) -> Dict[str, float]:
        """One step per batch of the loader's next epoch, one printed line
        each (``epoch`` labels them), each a row of ``logger`` when one is
        given (with ``timer``'s images/s); returns the last step's
        metrics."""
        metrics: Dict[str, float] = {}
        for i, batch in enumerate(prefetch_to_device(
                (b.arrays(finest_only=True) for b in self.train_batches),
                self.device)):
            t0 = time.perf_counter()
            out = self.step_fn(batch)
            if logger is not None:
                timer.tick()
                logger.log(self.state.step, dict(
                    out, images_per_sec=timer.images_per_sec))
            metrics = {k: float(v) for k, v in out.items()}
            if self.mesh.rank != 0:
                continue
            print(f"| epoch {epoch:3d} | {i + 1:4d}/"
                  f"{len(self.train_batches):4d} batches | step "
                  f"{self.state.step} | "
                  + " ".join(f"{k} {v:.4f}" for k, v in metrics.items())
                  + f" | {time.perf_counter() - t0:.2f}s", flush=True)
        return metrics

    def save_attention_figure(self, epoch: int) -> None:
        """``Image/attn_epoch<epoch>.png``: the word-region attention
        (``word_region_attention`` of the words without <sos>/<eos> over
        the image regions, GAMMA1) of the first 4 records of the
        validation loader's probe batch, over their images
        (:func:`attention_grid`), as the JAX trainer draws it; f32."""
        batch = self.val_batches.peek(whole=True)
        if batch is None:
            return
        clip = self.state.clip
        images = np.asarray(batch.images[-1][:4])
        ids = torch.as_tensor(np.asarray(batch.input_ids[:4]),
                              device=self.device)
        mask = torch.as_tensor(np.asarray(batch.attention_mask[:4]),
                               device=self.device)
        with torch.no_grad():
            subr, _ = clip.encode_image_verbose(
                torch.as_tensor(images, device=self.device))
            words, _ = clip.encode_text_verbose(ids, mask)
            w, m = strip_special_tokens(words, mask)
            _, attn = word_region_attention(
                w, subr[:, 1:, :], m, self.cfg.TRAIN.SMOOTH.GAMMA1)
        grid = attention_grid(denormalize_clip(images), attn.cpu().numpy(),
                              word_labels(self.tokenizer,
                                          batch.input_ids[:4]))
        write_png(os.path.join(self.output_dir, "Image",
                               f"attn_epoch{epoch}.png"), grid)

    def device_batch(self, batch) -> Dict:
        """A loader batch as the DAMSM step's: the finest images, both
        caption views and the class ids, on the trainer's device."""
        return put_batch(batch.arrays(finest_only=True), self.device)

    def evaluate(self, max_batches: Optional[int] = None) -> Dict[str, float]:
        """Mean ``s_loss`` and ``w_loss`` over the validation split, capped
        at ``max_batches`` (default ``TRAIN.EVAL_MAX_BATCHES``, 0 = no
        cap)."""
        if max_batches is None:
            max_batches = self.cfg.TRAIN.EVAL_MAX_BATCHES or None
        s_total, w_total, n = 0.0, 0.0, 0
        with torch.no_grad():
            for i, batch in enumerate(self.val_batches):
                if max_batches is not None and i >= max_batches:
                    break
                _, m = self.eval_loss_fn(self.device_batch(batch))
                s_total += float(m["s_loss"])
                w_total += float(m["w_loss"])
                n += 1
        n = max(n, 1)
        return {"s_loss": s_total / n, "w_loss": w_total / n}


def main(argv: Optional[Sequence[str]] = None,
         clip_cfg: ClipConfig = ClipConfig()) -> DamsmTrainer:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cfg", required=True, help="YAML config")
    p.add_argument("--max_epochs", type=int, default=None,
                   help="epochs to run (default TRAIN.MAX_EPOCH)")
    p.add_argument("--batch", type=int, default=None,
                   help="batch size (default TRAIN.BATCH_SIZE)")
    p.add_argument("--output_dir", default=None,
                   help="default output/<DATASET_NAME>_<CONFIG_NAME>")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="f32")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    cfg = cfg_from_file(args.cfg)
    if args.batch:
        cfg = cfg_replace(cfg, TRAIN={"BATCH_SIZE": args.batch})
    output_dir = args.output_dir or os.path.join(
        "output", f"{cfg.DATASET_NAME}_{cfg.CONFIG_NAME}")
    trainer = DamsmTrainer(cfg, output_dir, args.device,
                           DTYPES[args.dtype], args.seed, clip_cfg)
    trainer.train(args.max_epochs)
    return trainer
