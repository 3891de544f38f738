"""Where the sampler's time goes on the card.

    python -m t2igan_torch.profile_sampler [--batch 128] [--dtype bf16] \
        [--iters 3] [--trace PATH]

Runs the sampler at the widths of ``configs/eval_clip_bird.yml`` (full
ViT-B/32 text tower, weights from a seed, the JAX bench's inputs: ids all
<eos>, full mask) under ``torch.profiler`` for ``--iters`` calls after a
warm-up, reads the CUDA kernels from the exported Chrome trace, and prints
per call: the device busy time, the device idle share of the window, the
time by kernel family, and the top kernels.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import tempfile

import torch

from t2igan_torch.config import cfg_from_dict
from t2igan_torch.configs import EVAL_CLIP_BIRD
from t2igan_torch.generate import DTYPES, build_models
from t2igan_torch.train.steps import make_sampler

# Kernel families by a substring of the kernel name, first match wins.
FAMILIES = (
    ("memory_read_fwd (K1)", ("memory_read_fwd",)),
    ("nearest upsample", ("upsample",)),
    ("batch norm", ("batch_norm", "bn_fw")),
    ("convolution", ("fprop", "conv", "cudnn")),
    ("matmul (CLIP, dense)", ("gemm", "cutlass", "cublas")),
    ("softmax", ("softmax",)),
    ("reduction", ("reduce",)),
    ("concatenation", ("catarray",)),
    ("GLU", ("glu",)),
    ("elementwise (gates, residuals, casts)", ("elementwise",)),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--trace", default="", help="keep the Chrome trace here")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_sampler needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()

    cfg = cfg_from_dict(EVAL_CLIP_BIRD)
    clip, gen = build_models(cfg, 0, torch.device("cuda"), DTYPES[args.dtype])
    sample = make_sampler(cfg, clip, gen)
    b, w = args.batch, cfg.TEXT.WORDS_NUM
    ids = torch.full((b, w), clip.cfg.eos_token_id, dtype=torch.int32,
                     device="cuda")
    mask = torch.ones((b, w), dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    z = torch.randn((b, cfg.GAN.Z_DIM), generator=g, device="cuda")
    eps = torch.randn((b, cfg.GAN.CONDITION_DIM), generator=g, device="cuda")
    for _ in range(3):
        sample(ids, mask, z, eps)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.iters):
            sample(ids, mask, z, eps)
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
    print(f"[{card}] sampler {args.dtype} batch {b}: device busy "
          f"{busy:.3f} ms/call, window {window:.3f} ms/call, idle share "
          f"{1 - busy / window:.1%}, {len(kernels) // args.iters} kernels/call")
    for fam, ms in by_family.most_common():
        print(f"  {fam:40s} {ms:9.3f} ms  {ms / busy:6.1%}")
    print("  top kernels:")
    for name, ms in by_name.most_common(12):
        print(f"    {ms:8.3f} ms {ms / busy:6.1%} x{launches[name] // args.iters}"
              f"  {name[:110]}")


if __name__ == "__main__":
    main()
