"""Where a step's time goes on the card, by kernel family.

    python -m t2igan_torch.profile_step [--path sampler|train] [--batch N] \
        [--dtype bf16|f32] [--iters 3] [--trace PATH]

``--path sampler`` (default batch 128) runs the sampler at the widths of
``configs/eval_clip_bird.yml`` on the JAX bench's gen inputs (ids all
<eos>, full mask); ``--path train`` (default batch 16) runs the
adversarial step at the widths of ``configs/clip_bird_dmgan.yml`` on the
JAX bench's train fixtures (lr 2e-5).  Weights come from a seed.  After a
warm-up it records ``--iters`` calls under ``torch.profiler``, reads the
CUDA kernels from the exported Chrome trace, and prints per call: the
device busy time, the device idle share of the window, the time by kernel
family, and the top kernels.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import tempfile

import torch

from t2igan_torch.config import cfg_from_dict, cfg_replace
from t2igan_torch.configs import CLIP_BIRD_DMGAN, EVAL_CLIP_BIRD
from t2igan_torch.data.synthetic import bench_train_batches
from t2igan_torch.generate import DTYPES, build_models
from t2igan_torch.train.steps import make_sampler
from t2igan_torch.train.train_gan import CondGanTrainer

# Kernel families by a substring of the kernel name, first match wins.
FAMILIES = (
    ("memory_read_fwd (K1)", ("memory_read_fwd",)),
    ("memory_read_bwd (K2)", ("memory_read_bwd",)),
    ("nearest upsample", ("upsample",)),
    ("batch norm", ("batch_norm", "bn_fw", "bn_bw")),
    ("convolution", ("fprop", "dgrad", "wgrad", "conv", "cudnn")),
    ("matmul (CLIP, dense)", ("gemm", "cutlass", "cublas")),
    ("optimizer (foreach)", ("multi_tensor", "foreach")),
    ("softmax", ("softmax",)),
    ("reduction", ("reduce",)),
    ("concatenation", ("catarray",)),
    ("GLU", ("glu",)),
    ("elementwise (gates, residuals, casts, BN stats)", ("elementwise",)),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def sampler_call(batch: int, dtype: torch.dtype):
    cfg = cfg_from_dict(EVAL_CLIP_BIRD)
    clip, gen = build_models(cfg, 0, torch.device("cuda"), dtype)
    sample = make_sampler(cfg, clip, gen)
    w = cfg.TEXT.WORDS_NUM
    ids = torch.full((batch, w), clip.cfg.eos_token_id, dtype=torch.int32,
                     device="cuda")
    mask = torch.ones((batch, w), dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    z = torch.randn((batch, cfg.GAN.Z_DIM), generator=g, device="cuda")
    eps = torch.randn((batch, cfg.GAN.CONDITION_DIM), generator=g,
                      device="cuda")
    return lambda: sample(ids, mask, z, eps)


def train_call(batch: int, dtype: torch.dtype):
    cfg = cfg_replace(cfg_from_dict(CLIP_BIRD_DMGAN),
                      TRAIN={"BATCH_SIZE": batch, "DISCRIMINATOR_LR": 2e-5,
                             "GENERATOR_LR": 2e-5})
    trainer = CondGanTrainer(cfg, "cuda", dtype, seed=0)
    batches = [{k: ([torch.as_tensor(x, device="cuda") for x in v]
                    if k == "images" else torch.as_tensor(v, device="cuda"))
                for k, v in b.items()}
               for b in bench_train_batches(batch,
                                            trainer.clip.cfg.eos_token_id)]
    it = iter(range(10 ** 9))
    return lambda: trainer.step_fn(trainer.state,
                                   batches[next(it) % len(batches)],
                                   generator=trainer.noise)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--path", choices=["sampler", "train"], default="sampler")
    p.add_argument("--batch", type=int, default=None,
                   help="default 128 (sampler) or 16 (train)")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--trace", default="", help="keep the Chrome trace here")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    b = args.batch or (128 if args.path == "sampler" else 16)
    make = sampler_call if args.path == "sampler" else train_call
    call = make(b, DTYPES[args.dtype])
    for _ in range(3):
        call()
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.iters):
            call()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = args.trace or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise SystemExit("the trace holds no CUDA kernel: the profiler did "
                         "not trace the card")
    busy = sum(e["dur"] for e in kernels) / 1e3 / args.iters
    start = min(e["ts"] for e in kernels)
    stop = max(e["ts"] + e["dur"] for e in kernels)
    window = (stop - start) / 1e3 / args.iters
    by_family = collections.Counter()
    by_name = collections.Counter()
    launches = collections.Counter()
    for e in kernels:
        by_family[family(e["name"])] += e["dur"] / 1e3 / args.iters
        by_name[e["name"]] += e["dur"] / 1e3 / args.iters
        launches[e["name"]] += 1
    print(f"[{card}] {args.path} {args.dtype} batch {b}: device busy "
          f"{busy:.3f} ms/call, window {window:.3f} ms/call, idle share "
          f"{1 - busy / window:.1%}, {len(kernels) // args.iters} kernels/call")
    for fam, ms in by_family.most_common():
        print(f"  {fam:48s} {ms:9.3f} ms  {ms / busy:6.1%}")
    print("  top kernels:")
    for name, ms in by_name.most_common(12):
        print(f"    {ms:8.3f} ms {ms / busy:6.1%} x{launches[name] // args.iters}"
              f"  {name[:110]}")


if __name__ == "__main__":
    main()
