"""Generate images for captions with the port's sampler.

    python -m t2igan_torch.generate --cfg t2igan_torch/configs/eval_clip_bird.yml \
        --captions captions.txt [--batch N] [--dtype bf16|f32] [--seed S] \
        [--device cuda|cpu] [--output_dir DIR]

The ``gen_example`` flow of the JAX trainer without attention grids: the
captions (one per line) are tokenized, ``z`` and the conditioning noise are
drawn from a seeded ``torch.Generator``, the sampler runs, and each
caption's 64, 128 and 256 px images are written as ``<i>_g<k>.png``.
Weights are random, made from ``--seed`` (checkpoints are a later slice).
The default device is ``cuda``; without a card this raises rather than
falling back to the CPU.
"""

from __future__ import annotations

import argparse
import os
import struct
import zlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from t2igan_torch.config import Config, cfg_from_file
from t2igan_torch.data.tokenizer import ClipTokenizer
from t2igan_torch.models.clip import (ClipConfig, ClipWithRegionHead,
                                      init_clip_)
from t2igan_torch.models.factory import build_generator
from t2igan_torch.models.generator import init_generator_
from t2igan_torch.ops.image import uint8_from_tanh
from t2igan_torch.train.steps import make_sampler

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an [H, W, 3] uint8 array as an 8-bit RGB PNG (zlib only)."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + chunk(b"IEND", b""))


def build_models(cfg: Config, seed: int, device: torch.device,
                 dtype: torch.dtype, clip_cfg: ClipConfig = ClipConfig()):
    """CLIP and the generator with random weights from
    ``seed``, on ``device`` in ``dtype``, feature maps channels-last."""
    rng = torch.Generator().manual_seed(seed)
    clip = init_clip_(ClipWithRegionHead(clip_cfg), rng)
    gen = init_generator_(build_generator(cfg), rng)
    clip = clip.to(device=device, dtype=dtype).eval()
    gen = gen.to(device=device, dtype=dtype,
                 memory_format=torch.channels_last).eval()
    return clip, gen


def generate(cfg: Config, captions: Sequence[str], output_dir: Optional[str],
             batch: int, dtype: torch.dtype = torch.float32, seed: int = 0,
             device: str = "cuda",
             clip_cfg: ClipConfig = ClipConfig()) -> List[List[torch.Tensor]]:
    """Sample every caption, ``batch`` at a time; write the PNGs when
    ``output_dir`` is given.  Returns each batch's images [b, s, s, 3]."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: t2igan_torch.generate runs on the "
                           "card by default; pass --device cpu to run on the "
                           "CPU")
    clip, gen = build_models(cfg, seed, dev, dtype, clip_cfg)
    sampler = make_sampler(cfg, clip, gen)
    tokenizer = ClipTokenizer.load(cfg.DATA_DIR)
    noise = torch.Generator().manual_seed(seed + 1)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    results = []
    for start in range(0, len(captions), batch):
        tok = tokenizer(list(captions[start:start + batch]),
                        max_length=cfg.TEXT.WORDS_NUM)
        b = tok["input_ids"].shape[0]
        z = torch.randn((b, cfg.GAN.Z_DIM), generator=noise)
        eps = torch.randn((b, cfg.GAN.CONDITION_DIM), generator=noise)
        fakes = sampler(tok["input_ids"], tok["attention_mask"], z, eps)
        results.append(fakes)
        if output_dir:
            for k, stage in enumerate(fakes):
                u8 = uint8_from_tanh(stage).cpu().numpy()
                for j in range(b):
                    write_png(os.path.join(output_dir,
                                           f"{start + j}_g{k}.png"), u8[j])
    return results


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cfg", required=True, help="YAML config")
    p.add_argument("--captions", required=True,
                   help="text file, one caption per line")
    p.add_argument("--batch", type=int, default=None,
                   help="captions per sampler call (default TRAIN.BATCH_SIZE)")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="f32")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--output_dir", default="output/gen_torch")
    args = p.parse_args(argv)
    cfg = cfg_from_file(args.cfg)
    with open(args.captions, encoding="utf-8") as f:
        captions = [line.strip() for line in f if line.strip()]
    if not captions:
        raise SystemExit(f"no captions in {args.captions}")
    generate(cfg, captions, args.output_dir,
             args.batch or cfg.TRAIN.BATCH_SIZE, DTYPES[args.dtype],
             args.seed, args.device)
    print(f"wrote {cfg.TREE.BRANCH_NUM * len(captions)} images to "
          f"{args.output_dir}")


if __name__ == "__main__":
    main()
