"""Conditional GAN trainer: the port's counterpart of
``t2igan.train.train_gan.CondGanTrainer``, without G/D checkpoints.

    python -m t2igan_torch.train_gan --cfg t2igan_torch/configs/clip_bird_dmgan.yml \
        --steps N [--batch B] [--dtype bf16|f32] [--device cuda|cpu] [--seed S]

It builds CLIP (from ``TRAIN.CLIP_MODEL_CHECKPOINT`` when that names an
existing ``clip%d.pth``, as ``python -m t2igan_torch.pretrain_damsm``
writes them), the generator and one discriminator per pyramid size with
random weights from ``--seed``, tokenizes the synthetic dataset's captions
(``TEXT.WORDS_NUM`` tokens), takes ``--steps`` adversarial steps
(:func:`t2igan_torch.train.steps.make_gan_step`) and prints one
``[step] Loss_D: ... Loss_G: ...`` line per step.  CLIP stays frozen.
The default device is ``cuda``; without a card this raises rather than
falling back to the CPU.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from t2igan_torch.config import Config, cfg_from_file, cfg_replace
from t2igan_torch.data.synthetic import SyntheticDataset
from t2igan_torch.data.tokenizer import ClipTokenizer
from t2igan_torch.models.clip import ClipConfig
from t2igan_torch.models.discriminator import init_discriminator_
from t2igan_torch.models.factory import (build_discriminators,
                                         build_generator, load_clip)
from t2igan_torch.models.generator import init_generator_
from t2igan_torch.train.state import init_gan_state
from t2igan_torch.train.steps import make_gan_step

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


class CondGanTrainer:
    """Models, train state and data for ``steps`` adversarial steps.

    ``dtype`` is the precision of the forwards (parameters stay f32);
    ``clip_cfg`` the CLIP widths (ViT-B/32 by default)."""

    def __init__(self, cfg: Config, device: str = "cuda",
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 clip_cfg: ClipConfig = ClipConfig()):
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: t2igan_torch.train_gan runs "
                               "on the card by default; pass --device cpu "
                               "to run on the CPU")
        self.cfg = cfg
        self.tokenizer = ClipTokenizer.load(cfg.DATA_DIR or None)
        self.dataset = SyntheticDataset(cfg, seed=seed)
        rng = torch.Generator().manual_seed(seed)
        self.clip = load_clip(cfg, clip_cfg, rng).requires_grad_(False).to(
            dev)
        gen = init_generator_(build_generator(cfg), rng).train()
        ds = [init_discriminator_(d, rng).train()
              for d in build_discriminators(cfg)]
        gen = gen.to(dev, memory_format=torch.channels_last)
        ds = [d.to(dev, memory_format=torch.channels_last) for d in ds]
        self.state = init_gan_state(cfg, gen, ds)
        self.step_fn = make_gan_step(cfg, self.clip, dtype)
        self.noise = torch.Generator(device=dev).manual_seed(seed + 1)
        self.order = np.random.default_rng(seed)

    def batches(self) -> Iterator[Dict]:
        """Shuffled batches of ``TRAIN.BATCH_SIZE`` records, epoch after
        epoch (a last partial batch is dropped)."""
        b, words = self.cfg.TRAIN.BATCH_SIZE, self.cfg.TEXT.WORDS_NUM
        while True:
            perm = self.order.permutation(len(self.dataset))
            for start in range(0, len(perm) - b + 1, b):
                recs = [self.dataset[int(i)] for i in perm[start:start + b]]
                tok1 = self.tokenizer([r.caption for r in recs], words)
                tok2 = self.tokenizer([r.caption_2 for r in recs], words)
                yield {
                    "images": [np.stack([r.images[k] for r in recs])
                               for k in range(len(recs[0].images))],
                    "ids": tok1["input_ids"],
                    "mask": tok1["attention_mask"],
                    "ids_2": tok2["input_ids"],
                    "mask_2": tok2["attention_mask"],
                    "class_ids": np.asarray([r.class_id for r in recs]),
                }

    def train(self, steps: int) -> Dict[str, float]:
        """Take ``steps`` steps; returns the last step's metrics."""
        metrics: Dict[str, float] = {}
        batches = self.batches()
        for _ in range(steps):
            t0 = time.perf_counter()
            out = self.step_fn(self.state, next(batches),
                               generator=self.noise)
            metrics = {k: float(v) for k, v in out.items()}
            d_loss = sum(metrics[f"d_loss{i}"]
                         for i in range(len(self.state.ds)))
            print(f"[{self.state.step}] Loss_D: {d_loss:.4f} "
                  f"Loss_G: {metrics['g_loss']:.4f} "
                  f"Time: {time.perf_counter() - t0:.2f}s", flush=True)
        return metrics


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
    trainer.train(args.steps)
    return trainer
