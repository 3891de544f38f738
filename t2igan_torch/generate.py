"""Generate images for captions with the port's sampler.

    python -m t2igan_torch.generate --cfg t2igan_torch/configs/eval_clip_bird.yml \
        --captions captions.txt [--weights Model/netG_epoch_N.pth|G.npz] \
        [--batch N] [--dtype bf16|f32] [--seed S] [--device cuda|cpu] \
        [--output_dir DIR]

The ``gen_example`` flow of the JAX trainer without attention grids: the
captions (one per line) are tokenized, ``z`` and the conditioning noise are
drawn from a seeded ``torch.Generator``, the sampler runs, and each
caption's 64, 128 and 256 px images are written as ``<i>_g<k>.png`` (with
``GAN.B_DCGAN: True``, the one 256 px image as ``<i>_g0.png``).
The generator's weights come from ``--weights`` (a ``netG_epoch_%d.pth``
or the JAX package's ``.npz`` export), else from ``TRAIN.NET_G`` when it
names a file, else they are random, made from ``--seed``; CLIP's come from
``TRAIN.CLIP_MODEL_CHECKPOINT`` when it names a ``clip%d.pth``, else from
the seed too.  It prints which were used.  A config with ``GAN: {FUSED_TAIL: True}`` runs each stage's eval tail
through the fused tail kernel (K3).  The default device is ``cuda``;
without a card this raises rather than falling back to the CPU.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, List, Optional, Sequence

import torch

from t2igan_torch.config import Config, cfg_from_file
from t2igan_torch.data.tokenizer import ClipTokenizer
from t2igan_torch.models.clip import ClipConfig
from t2igan_torch.models.factory import build_generator, load_clip
from t2igan_torch.models.generator import init_generator_
from t2igan_torch.ops.image import uint8_from_tanh
from t2igan_torch.train.export import load_generator_weights
from t2igan_torch.train.steps import make_sampler
from t2igan_torch.utils.png import write_png
from t2igan_torch.utils.viz import attention_grid, tanh_to01, word_labels

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def generator_weights(cfg: Config, weights: Optional[str]) -> Optional[str]:
    """The generator file to read: ``weights``, else ``TRAIN.NET_G`` when
    it names a file, else None (random weights)."""
    if weights:
        if not os.path.isfile(weights):
            raise FileNotFoundError(f"--weights {weights!r} is not a file")
        return weights
    net_g = cfg.TRAIN.NET_G
    return net_g if net_g and os.path.isfile(net_g) else None


def build_models(cfg: Config, seed: int, device: torch.device,
                 dtype: torch.dtype, clip_cfg: ClipConfig = ClipConfig(),
                 weights: Optional[str] = None):
    """CLIP (``factory.load_clip``: ``TRAIN.CLIP_MODEL_CHECKPOINT`` or
    random weights from ``seed``) and the generator (the file ``weights``,
    or random weights from ``seed``), on ``device`` in ``dtype``, feature
    maps channels-last."""
    rng = torch.Generator().manual_seed(seed)
    clip = load_clip(cfg, clip_cfg, rng)
    gen = init_generator_(build_generator(cfg), rng)
    if weights:
        load_generator_weights(gen, weights)
    clip = clip.to(device=device, dtype=dtype).eval()
    gen = gen.to(device=device, dtype=dtype,
                 memory_format=torch.channels_last).eval()
    return clip, gen


def sample_and_write(cfg: Config, sampler, tokenizer: ClipTokenizer,
                     captions: Sequence[str], noise: torch.Generator,
                     output_dir: Optional[str],
                     name: Callable[[int, int], str],
                     grid_name: Optional[Callable[[int], str]] = None
                     ) -> List[torch.Tensor]:
    """Sample ``captions`` (tokenized to ``TEXT.WORDS_NUM``; ``z`` then
    ``eps`` drawn from ``noise``) and, when ``output_dir`` is given, write
    stage ``k``'s image of caption ``j`` as ``output_dir/name(j, k)``.
    With ``grid_name``, ``sampler`` is a ``return_attn`` one and stage
    ``k``'s attention maps over stage ``k + 1``'s images are written as
    the grid ``output_dir/grid_name(k)`` (:func:`attention_grid`, every
    caption a row).  Returns each stage's images [b, s, s, 3]."""
    tok = tokenizer(list(captions), max_length=cfg.TEXT.WORDS_NUM)
    b = tok["input_ids"].shape[0]
    z = torch.randn((b, cfg.GAN.Z_DIM), generator=noise)
    eps = torch.randn((b, cfg.GAN.CONDITION_DIM), generator=noise)
    out = sampler(tok["input_ids"], tok["attention_mask"], z, eps)
    fakes, atts = out if grid_name is not None else (out, [])
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        for k, stage in enumerate(fakes):
            u8 = uint8_from_tanh(stage).cpu().numpy()
            for j in range(b):
                write_png(os.path.join(output_dir, name(j, k)), u8[j])
        labels = word_labels(tokenizer, tok["input_ids"]) if atts else []
        for k, att in enumerate(atts):
            grid = attention_grid(
                tanh_to01(fakes[k + 1].float().cpu().numpy()),
                att.cpu().numpy(), labels)
            write_png(os.path.join(output_dir, grid_name(k)), grid)
    return fakes


def generate(cfg: Config, captions: Sequence[str], output_dir: Optional[str],
             batch: int, dtype: torch.dtype = torch.float32, seed: int = 0,
             device: str = "cuda", clip_cfg: ClipConfig = ClipConfig(),
             weights: Optional[str] = None) -> List[List[torch.Tensor]]:
    """Sample every caption, ``batch`` at a time, with the generator of
    :func:`generator_weights`; write the PNGs when ``output_dir`` is given.
    Returns each batch's images [b, s, s, 3]."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: t2igan_torch.generate runs on the "
                           "card by default; pass --device cpu to run on the "
                           "CPU")
    weights = generator_weights(cfg, weights)
    print(f"generator weights: {weights}" if weights else
          f"generator weights: random, from seed {seed}")
    clip, gen = build_models(cfg, seed, dev, dtype, clip_cfg, weights)
    sampler = make_sampler(cfg, clip, gen)
    tokenizer = ClipTokenizer.load(cfg.DATA_DIR)
    noise = torch.Generator().manual_seed(seed + 1)
    return [sample_and_write(cfg, sampler, tokenizer,
                             captions[start:start + batch], noise, output_dir,
                             lambda j, k, start=start: f"{start + j}_g{k}.png")
            for start in range(0, len(captions), batch)]


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cfg", required=True, help="YAML config")
    p.add_argument("--captions", required=True,
                   help="text file, one caption per line")
    p.add_argument("--weights", default=None,
                   help="generator weights: a netG_epoch_%%d.pth or a .npz "
                        "export (default TRAIN.NET_G when it is a file, "
                        "else random from --seed)")
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
             args.seed, args.device, weights=args.weights)
    per_caption = 1 if cfg.GAN.B_DCGAN else cfg.TREE.BRANCH_NUM
    print(f"wrote {per_caption * len(captions)} images to "
          f"{args.output_dir}")


if __name__ == "__main__":
    main()
