"""Where a step's time goes on the card, by kernel family.

    python -m t2igan_torch.profile_step [--path sampler|geneval|train|damsm|rank] \
        [--fused-tail] [--batch N] [--dtype bf16|f32] [--iters 3] \
        [--trace PATH] [--group]

``--path sampler`` (default batch 128) runs the sampler at the widths of
``configs/eval_clip_bird.yml`` on the JAX bench's gen inputs (ids all
<eos>, full mask); ``--path geneval`` (default batch 128) runs the same
sampler into the FID Inception-v3 (``pool3``), the JAX bench's
``--mode geneval``; ``--fused-tail`` sets ``GAN.FUSED_TAIL`` for either,
so each stage tail runs the fused tail kernel (K3); ``--path train``
(default batch 16) runs the
adversarial step at the widths of ``configs/clip_bird_dmgan.yml`` on the
JAX bench's train fixtures (lr 2e-5); ``--path damsm`` (default batch 48)
runs the DAMSM step at the widths of ``configs/damsm/bird.yml`` (ViT-B/32,
224 px, 30 tokens) on the JAX bench's DAMSM inputs (ids all <eos>, full
mask, class ids ``0..B-1``) with the optimizer scheduled over 100 steps an
epoch; ``--path rank`` (default batch 128) runs the R-precision sweep's rank
function (ViT-B/32 on 224 px images, the true and 99 mis-captions of 77
tokens an image, ids all <eos>, full mask).  Weights come from a seed.  After a
warm-up it records ``--iters`` calls under ``torch.profiler``, reads the
CUDA kernels from the exported Chrome trace, and prints per call: the
device busy time, the device idle share of the window, the time by kernel
family, and the top kernels.  ``--group`` runs the train path under a
process group of one rank over NCCL (the data-parallel code path at world
size 1) and adds the host time of its collectives per call.  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import tempfile

import torch
import torch.distributed as dist

from t2igan_torch.config import cfg_from_dict, cfg_replace
from t2igan_torch.configs import CLIP_BIRD_DMGAN, DAMSM_BIRD, EVAL_CLIP_BIRD
from t2igan_torch.data.synthetic import bench_damsm_batch, bench_train_batches
from t2igan_torch.evaluation.fid import make_gen_activation_fn
from t2igan_torch.evaluation.rprecision import make_rank_fn
from t2igan_torch.generate import DTYPES, build_models
from t2igan_torch.models.clip import init_clip_
from t2igan_torch.models.factory import build_clip
from t2igan_torch.models.inception import InceptionV3, init_inception_
from t2igan_torch.parallel.mesh import init_distributed
from t2igan_torch.train.state import damsm_optimizer, init_damsm_state
from t2igan_torch.train.steps import make_damsm_step, make_sampler
from t2igan_torch.train.train_gan import CondGanTrainer

# Kernel families by a substring of the kernel name, first match wins.
FAMILIES = (
    ("memory_read_fwd (K1)", ("memory_read_fwd",)),
    ("memory_read_bwd (K2)", ("memory_read_bwd",)),
    # K3 by launch kind: the bf16 kernels (conv_tc<mode, N>, rgb_head_tc)
    # and the f32 ones (reschain_conv<mode, ...>), names demangled or not.
    ("K3 conv C->2C + GLU", ("conv_tc<0", "conv_tcili0e",
                             "reschain_conv<0", "reschain_convili0e")),
    ("K3 conv C->C + residual", ("conv_tc<1", "conv_tcili1e",
                                 "reschain_conv<1", "reschain_convili1e")),
    ("K3 upsample phases + GLU", ("conv_tc<2", "conv_tcili2e",
                                  "reschain_conv<2", "reschain_convili2e")),
    ("K3 RGB head", ("rgb_head_tc", "reschain_conv<3",
                     "reschain_convili3e")),
    ("nearest upsample", ("upsample",)),
    ("batch norm", ("batch_norm", "bn_fw", "bn_bw")),
    ("layer norm", ("layer_norm",)),
    ("convolution", ("fprop", "dgrad", "wgrad", "conv", "cudnn")),
    ("matmul (CLIP, dense)", ("gemm", "cutlass", "cublas", "nvjet")),
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


def sampler_call(batch: int, dtype: torch.dtype, fused_tail: bool = False,
                 geneval: bool = False):
    """The sampler (or, with ``geneval``, the sampler into Inception
    pool3) on the JAX bench's gen inputs, weights from seeds."""
    cfg = cfg_replace(cfg_from_dict(EVAL_CLIP_BIRD),
                      GAN={"FUSED_TAIL": fused_tail})
    clip, gen = build_models(cfg, 0, torch.device("cuda"), dtype)
    if geneval:
        inception = init_inception_(InceptionV3("fid"),
                                    torch.Generator().manual_seed(7))
        inception = inception.to("cuda", dtype,
                                 memory_format=torch.channels_last).eval()
        sample = make_gen_activation_fn(cfg, clip, gen, inception)
    else:
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


def rank_call(batch: int, dtype: torch.dtype, n_mis: int = 99):
    """The sweep's rank function at ``batch`` images of 224 px, each
    against 1 + ``n_mis`` captions of 77 tokens (all <eos>, full mask)."""
    clip = init_clip_(build_clip(), torch.Generator().manual_seed(0))
    clip = clip.to("cuda", dtype).eval()
    rank = make_rank_fn(clip)
    g = torch.Generator(device="cuda").manual_seed(3)
    size, w = clip.cfg.image_size, clip.cfg.max_positions
    images = torch.tanh(torch.randn((batch, size, size, 3), generator=g,
                                    device="cuda"))
    ids = torch.full((batch, w), clip.cfg.eos_token_id, dtype=torch.int32,
                     device="cuda")
    mask = torch.ones_like(ids)
    mis_ids = ids[:, None].expand(batch, n_mis, w).contiguous()
    mis_mask = torch.ones_like(mis_ids)
    return lambda: rank(images, ids, mask, mis_ids, mis_mask)


def train_call(batch: int, dtype: torch.dtype, mesh=None):
    cfg = cfg_replace(cfg_from_dict(CLIP_BIRD_DMGAN),
                      TRAIN={"BATCH_SIZE": batch, "DISCRIMINATOR_LR": 2e-5,
                             "GENERATOR_LR": 2e-5})
    trainer = CondGanTrainer(cfg, "cuda", dtype, seed=0, mesh=mesh)
    batches = [{k: ([torch.as_tensor(x, device="cuda") for x in v]
                    if k == "images" else torch.as_tensor(v, device="cuda"))
                for k, v in b.items()}
               for b in bench_train_batches(batch,
                                            trainer.clip.cfg.eos_token_id)]
    it = iter(range(10 ** 9))
    return lambda: trainer.step_fn(trainer.state,
                                   batches[next(it) % len(batches)],
                                   generator=trainer.noise)


def damsm_call(batch: int, dtype: torch.dtype):
    cfg = cfg_replace(cfg_from_dict(DAMSM_BIRD),
                      TRAIN={"BATCH_SIZE": batch})
    clip = init_clip_(build_clip(), torch.Generator().manual_seed(0))
    state = init_damsm_state(cfg, clip.to("cuda"),
                             damsm_optimizer(cfg, steps_per_epoch=100))
    step = make_damsm_step(cfg, state.clip, state.opt, dtype)
    inputs = {k: torch.as_tensor(v, device="cuda") for k, v in
              bench_damsm_batch(batch, clip.cfg.eos_token_id).items()}
    return lambda: step(inputs)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--path", choices=["sampler", "geneval", "train", "damsm",
                                       "rank"],
                   default="sampler")
    p.add_argument("--fused-tail", action="store_true",
                   help="GAN.FUSED_TAIL for the sampler and geneval paths")
    p.add_argument("--batch", type=int, default=None,
                   help="default 128 (sampler, geneval, rank), 16 (train) "
                        "or 48 (damsm)")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--trace", default="", help="keep the Chrome trace here")
    p.add_argument("--group", action="store_true",
                   help="the train path under a one-rank NCCL group")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    if args.fused_tail and args.path in ("train", "damsm", "rank"):
        raise SystemExit("--fused-tail is eval only: the train steps run "
                         "the module chain")
    b = args.batch or {"train": 16, "damsm": 48}.get(args.path, 128)
    if args.group and args.path != "train":
        raise SystemExit("--group is for the train path")
    if args.path == "train":
        mesh = None
        if args.group:
            store = tempfile.NamedTemporaryFile(delete=False).name
            os.unlink(store)
            dist.init_process_group("nccl", store=dist.FileStore(store, 1),
                                    rank=0, world_size=1)
            mesh = init_distributed("cuda", "nccl")
        call = train_call(b, DTYPES[args.dtype], mesh)
    elif args.path == "damsm":
        call = damsm_call(b, DTYPES[args.dtype])
    elif args.path == "rank":
        call = rank_call(b, DTYPES[args.dtype])
    else:
        call = sampler_call(b, DTYPES[args.dtype], args.fused_tail,
                            geneval=args.path == "geneval")
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
    tail = " fused tail" if args.fused_tail else ""
    tail += " under a one-rank NCCL group" if args.group else ""
    print(f"[{card}] {args.path}{tail} {args.dtype} batch {b}: device busy "
          f"{busy:.3f} ms/call, window {window:.3f} ms/call, idle share "
          f"{1 - busy / window:.1%}, {len(kernels) // args.iters} kernels/call")
    for fam, ms in by_family.most_common():
        print(f"  {fam:48s} {ms:9.3f} ms  {ms / busy:6.1%}")
    print("  top kernels:")
    for name, ms in by_name.most_common(12):
        print(f"    {ms:8.3f} ms {ms / busy:6.1%} x{launches[name] // args.iters}"
              f"  {name[:110]}")
    if args.group:
        # The collectives' host ops (c10d, the autograd all_reduce) and
        # their NCCL kernels, per call.
        ops = [e for e in events if e.get("cat") == "cpu_op" and any(
            t in e["name"].lower() for t in ("c10d", "allreduce",
                                             "all_reduce", "broadcast"))]
        host = collections.Counter()
        for e in ops:
            host[e["name"]] += e["dur"] / 1e3 / args.iters
        nccl = [e for e in kernels if "nccl" in e["name"].lower()]
        print(f"  collectives: {len(nccl) // args.iters} NCCL kernels/call, "
              f"{sum(e['dur'] for e in nccl) / 1e3 / args.iters:.3f} ms "
              f"device/call; host ops (ms/call, nested ops counted in each):")
        for name, ms in host.most_common(8):
            print(f"    {ms:8.3f} ms  {name[:100]}")
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
