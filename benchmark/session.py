"""What the entries share: the program's config and models built from a
cell's configuration, the benchmark's weights loaded into them and into
the reference, and the calls the check keeps."""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from benchmark import traffic, weights
from benchmark.reference import nets

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


class SetupClock:
    """Prints where set-up time goes, one line a phase on standard
    error."""

    def __init__(self):
        self.t = time.perf_counter()

    def lap(self, phase: str) -> None:
        now = time.perf_counter()
        print(f"set-up {phase}: {now - self.t:.2f} s", file=sys.stderr,
              flush=True)
        self.t = now


def cuda_context(device) -> None:
    """Create the device's context (the process's first work on it)."""
    torch.empty(1, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_tf32(config: dict) -> None:
    """The configuration records the TF32 switches it runs under, as torch
    sets them by default; the harness sets neither, and refuses to run
    under others."""
    want = config["tf32"]
    have = {"matmul": torch.backends.cuda.matmul.allow_tf32,
            "cudnn": torch.backends.cudnn.allow_tf32}
    if have != want:
        raise RuntimeError(f"TF32 switches {have}, the configuration "
                           f"states {want}")


def program_cfg(cell, train: bool, batch: int):
    """The program's :class:`Config` at the configuration's widths."""
    from t2igan_torch.config import cfg_from_dict

    w, t = cell.config["widths"], cell.config["train"]
    return cfg_from_dict({
        "DATA_DIR": "", "WORKERS": 1,
        "TREE": {"BRANCH_NUM": w["BRANCH_NUM"], "BASE_SIZE": w["BASE_SIZE"]},
        "GAN": {"GF_DIM": w["GF_DIM"], "DF_DIM": w["DF_DIM"],
                "Z_DIM": w["Z_DIM"], "R_NUM": w["R_NUM"],
                "CONDITION_DIM": w["CONDITION_DIM"],
                "FUSED_TAIL": cell.fused_tail},
        "TEXT": {"EMBEDDING_DIM": w["EMBEDDING_DIM"],
                 "WORDS_NUM": w["WORDS_NUM"]},
        "TRAIN": {"FLAG": train, "BATCH_SIZE": batch, "NET_G": "",
                  "CLIP_MODEL_CHECKPOINT": "",
                  "GENERATOR_LR": t["GENERATOR_LR"],
                  "DISCRIMINATOR_LR": t["DISCRIMINATOR_LR"],
                  "SMOOTH": dict(t["SMOOTH"])}})


def clip_config(cell):
    """The program's :class:`ClipConfig` at the configuration's widths."""
    from t2igan_torch.models.clip import ClipConfig, ClipTowerConfig

    c = dict(cell.config["clip"])
    return ClipConfig(**{**c, "text": ClipTowerConfig(**c["text"]),
                         "vision": ClipTowerConfig(**c["vision"])})


def reference_widths(cell) -> nets.ClipWidths:
    return nets.ClipWidths.from_json(cell.config["clip"])


def make_weights(cell, seed: int, device) -> Dict[str, torch.Tensor]:
    """f32 weights of every model, named ``clip.``, ``gen.`` and
    ``d<i>.`` plus the port's names, from the seed.

    Models are built on ``device``, not on the meta device: a meta
    tensor's ``normal_`` runs through torch's Python decompositions, whose
    first use imports ``torch._dynamo`` (7-9 s of set-up on the card)."""
    with torch.device(device):
        clip, gen, ds = nets.build(cell.config["widths"],
                                   reference_widths(cell))
    shapes = weights.state_shapes(clip, "clip.") + \
        weights.state_shapes(gen, "gen.")
    for i, d in enumerate(ds):
        shapes += weights.state_shapes(d, f"d{i}.")
    return weights.make(shapes, traffic.derive(seed, 0), device)


def part(ws: Dict[str, torch.Tensor], prefix: str,
         dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The entries under ``prefix``, without it, rounded to ``dtype`` and
    back to f32 (the values a model served in ``dtype`` holds)."""
    return {k[len(prefix):]: v.to(dtype).float() for k, v in ws.items()
            if k.startswith(prefix)}


def load(module: torch.nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Copy ``state`` into ``module``'s tensors, every key matched."""
    with torch.no_grad():
        module.load_state_dict(state, strict=True)


def served_models(cell, cfg, ws, dtype, device):
    """The program's CLIP and generator, built on ``device`` (no host
    initialisation) in ``dtype`` (feature maps channels-last, as its
    ``build_models``), holding ``ws``."""
    from t2igan_torch.models.factory import build_clip, build_generator

    with torch.device(device):
        clip = build_clip(clip_config(cell))
        gen = build_generator(cfg)
    clip = clip.to(dtype).eval()
    gen = gen.to(dtype=dtype, memory_format=torch.channels_last).eval()
    load(clip, part(ws, "clip."))
    load(gen, part(ws, "gen."))
    return clip.requires_grad_(False), gen.requires_grad_(False)


def reference_models(cell, ws, device, dtype=torch.float32):
    """The reference's CLIP, generator and discriminators in f32 on
    ``device``, holding ``ws`` as a model served in ``dtype`` holds
    them."""
    with torch.device(device):
        clip, gen, ds = nets.build(cell.config["widths"],
                                   reference_widths(cell))
    load(clip, part(ws, "clip.", dtype))
    load(gen, part(ws, "gen.", dtype))
    for i, d in enumerate(ds):
        load(d, part(ws, f"d{i}.", dtype))
    return clip, gen, ds


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def checked_batches(seed: int, batches: int, k: int) -> List[int]:
    """The ``k`` input batches whose last call in the window the check
    compares, drawn from the seed."""
    rng = np.random.default_rng(traffic.derive(seed, 4))
    return sorted(rng.choice(batches, size=min(k, batches),
                             replace=False).tolist())


class Reservoir:
    """A sample of ``k`` of the calls seen, each kept with equal chance,
    drawn from the seed."""

    def __init__(self, seed: int, k: int):
        self.k = k
        self.items: list = []
        self.seen = 0
        self._rng = np.random.default_rng(traffic.derive(seed, 4))

    def offer(self, make) -> None:
        """Keep ``make()`` with the reservoir's chance (not called when the
        call is not kept)."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
            return
        j = int(self._rng.integers(0, self.seen))
        if j < self.k:
            self.items[j] = make()


def u8(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8, truncating: the images handed to the PNG
    writer."""
    return torch.clamp((img.float() + 1.0) * 127.5, 0, 255).to(torch.uint8)


def rel_rms(diffs: Iterable[torch.Tensor], refs: Iterable[torch.Tensor]
            ) -> float:
    num = sum(float(d.double().pow(2).sum()) for d in diffs)
    den = sum(float(r.double().pow(2).sum()) for r in refs)
    return (num / den) ** 0.5 if den > 0 else float("inf")


def median(values: Iterable[float]) -> float:
    return float(np.median(np.asarray(list(values), dtype=np.float64)))


def norm_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's gap between the two norms, against the reference's norm
    of that leaf or of the median leaf, whichever is larger."""
    leaves = list(ref if leaves is None else leaves)
    med = median(ref[k] for k in leaves)
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30)
            for k in leaves}


def worst(gaps: Dict[str, float]) -> Tuple[float, str]:
    """The largest gap (NaN counts as largest) and its leaf."""
    k = max(gaps, key=lambda k: (gaps[k] != gaps[k], gaps[k]))
    return gaps[k], k
