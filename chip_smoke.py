#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card.  It imports
``t2igan_torch`` (never JAX or the ``t2igan`` package) and:

1. prints the card's name and power limit, builds every CUDA kernel with
   ``nvcc`` (one process per source, in parallel) and prints the build
   times and the ptxas registers and spills (per kernel for K3);
2. holds each kernel to its plain PyTorch version on the card, at the
   paths' shapes and at the edges of what the kernel takes, f32 and bf16,
   masked and unmasked, with ragged pixel counts, and prints the error
   beside its stated tolerance (for the bf16 memory read, the bounds that
   ``t2igan_torch.ops.kernels.memory_read`` derives from the kernels'
   rounding points, against the plain version and against float64): the
   memory-read forward (K1), and the
   memory-read backward (K2) with its zero gradients at padding, its
   run-to-run determinism and the ``MemoryRead`` autograd pairing; the
   fused eval stage tail (K3) at the sampler's stage shapes and at its
   edges (R = 1 and 3, 17x19, C = 16, batch 1, BN shifts +3 at the
   border, and the bf16 kernels' tile edges: 96x40, a ragged 24x100,
   H = 1, batch 1 at 128^2 with the head), and K3 on folded weights
   against the port's eval module chain;
2b. holds the train-mode BN kernels (``csrc/batchnorm.cu``) to their plain
   stages at the 15 BN shapes of the train cell's G forward (batch 16),
   bf16 and f32: outputs, running statistics and the gradients of x,
   weight, bias and the residual through ``BatchNormTrain``, and a clean
   ``cudaGetLastError``; then times each shape's forward and backward
   beside the least bytes a fused layer moves and the plain stages;
3. drives the sampler: ``t2igan_torch.generate.generate`` at the widths of
   ``t2igan_torch/configs/eval_clip_bird.yml`` (full ViT-B/32 text tower,
   weights from a seed) on caption requests at the YAML's batch of 10, and
   checks the images and that each sampler call launched K1 exactly twice;
   then holds the f32 sampler on the card to the same sampler on the CPU
   and prints the bf16-vs-f32 gap;
3b. drives the same entry point with ``GAN.FUSED_TAIL: True`` (2 K1 and 2
   K3 launches per sampler call), holds the f32 fused sampler to the
   plain-tail sampler on the card and prints its bf16-vs-f32 gap;
3c. drives gen+eval (sampler, [0, 1] rescale, bilinear 299, FID
   Inception-v3 ``pool3``, random Inception weights from a seed) in both
   tail settings: launch counts, f32 ``pool3`` on the card against the
   CPU, and a finite Fréchet distance between two generated sets;
4. drives the train path: the ``train_gan`` trainer at the full width of
   ``configs/clip_bird_dmgan.yml`` (with ``GAN.FUSED_TAIL`` set, which
   training ignores) takes 3 bf16 steps at the YAML's batch of 4; it
   checks finite losses, that G, the discriminators, their spectral
   vectors and the EMA moved, the EMA rule, and 4 K1, 4 K2 and 0 K3
   launches per step, and 4 BN launches a BN, as counted and, for a
   replay of the step's CUDA graphs, by kernel name in its profiler trace
   (in a process of its own); then holds one f32 step on the card to the
   same step on the CPU at batch 2;
4b. drives DAMSM fine-tuning: the ``pretrain_damsm`` trainer at the full
   width of ``configs/damsm/bird.yml`` (ViT-B/32, batch 48, 224 px, 30
   tokens) for 2 epochs in bf16; it checks finite metrics, that both
   optimizer groups moved and ``logit_scale`` did not, each group's lr
   against its one-cycle schedule at every step, no K1, K2 or K3 launch,
   ``clip0.pth``/``clip1.pth``, bitwise-equal encodings from
   ``clip1.pth`` read into a fresh module, and ``CondGanTrainer`` holding
   exactly those weights through ``TRAIN.CLIP_MODEL_CHECKPOINT``, the
   attention figures ``attn_epoch%d.png`` and ``metrics.jsonl`` (one row a
   step, the JAX trainer's keys);
4c. holds one f32 DAMSM step on the card to the CPU at batch 4 (metrics
   and every gradient), then both optimizers fed the same gradients;
4d. holds the GAN step's CUDA graphs to its eager body: two trainers from
   one seed take 6 steps on the same batches, one through ``step_fn``
   (eager, capture, then replays: ``GAN_GRAPHS`` 1 / 1 / 5), one through
   ``step_fn.eager``, under PyTorch's deterministic algorithms; losses
   every step, then parameters, Adam's moments and step counts, running
   statistics and spectral vectors equal within 1e-6 of each tensor's
   largest entry; 4 K1, 4 K2 and 4 BN launches a BN in every step, as
   the wrappers count them (a replay's count copied from its capture); a
   fused-tail sample of the trained EMA G equals one of its fresh
   ``copy.deepcopy`` (the operand cache saw the replays); bf16 at
   ``clip_bird_dmgan.yml`` width and f32 at ``clip_coco_dmgan.yml``'s
   (R_NUM 3), each at its YAML's batch, then each path timed;
6. (run before phase 5's timings) drives the train -> checkpoint ->
   evaluate loop: ``CondGanTrainer.train`` at the full width of
   ``configs/clip_bird_dmgan.yml``, 2 epochs in bf16 at batch 4 with a
   snapshot after each (full state, ``netG_epoch_%d.pth``,
   ``netD%d.pth``, the sample sheet and its attention figure
   ``G_%d_attn.png``; 4 K1, 4 K2, 0 K3 launches a step, none for a sheet,
   whose maps read through einsums), ``metrics.jsonl`` (one row a step,
   the JAX trainer's keys), a
   fresh trainer resuming bitwise, ``netG_epoch_1.pth`` in a fresh GNet
   giving the bitwise f32 sampler output, ``sampling()`` from it at the
   widths of ``eval_clip_bird.yml`` (batch 10, one round, both tails: 2
   K1 and 2 or 0 K3 launches per sampler call, one PNG per kept record,
   R in [0, 1]), the f32 rank function on the card against the CPU at the
   sweep's batch of 10 with 99 mis-captions, the
   fused tail's operand cache after a weight load, and the sweep's
   sampler and rank function timed at batch 10 and 128;
5. times the sampler and gen+eval at batch 128 in both tail settings,
   the train step at batch 16 and the DAMSM step at batch 48 (the JAX
   bench's shapes) in bf16 (the DAMSM step in f32 too), and each
   kernel beside its plain version, its bound and one PyTorch library
   call where one computes the same function (K3 has none; the port's
   unfused eval module chain for the same tail is timed beside it, and
   cuDNN for each of its conv kinds, as a yardstick), with CUDA events.  The kernel rows are device times: the calls are queued
   behind a sleep kernel, so the card runs them back to back whatever the
   host takes to launch them; the host time of a wrapper call is printed
   beside them.  (5g) The f32 routes, every entry point's default dtype:
   K1 f32 (b128) and K2 f32 (b16) beside SDPA in f32 with TF32 off, K3
   f32 at R = 2 and 3 beside the f32 module chain, each against the f32
   bound (bytes, or the f32 work as 3xTF32 on the tensor cores), then
   the f32 train step at batch 16 and 4 and the f32 sampler at batch 128
   and 10, printed as one ``{"f32_rows": ...}`` line;
   ``time_f32`` runs these rows alone for an A/B against another tree.

7. (after phase 5) drives real data: the committed JPEG/PNG fixtures
   decoded by the port's own decoder and held to the sha256 of PIL's RGB
   bytes recorded beside them; a CUB-shaped tree written from the CUB-sized
   fixtures (96 train and 32 test records over 8 classes); the loader
   alone at clip_bird_dmgan.yml's pyramid (batch 16) and damsm/bird.yml's
   224 px (batch 48), each at its YAML's WORKERS and at 8, with where its
   time goes on one thread; CondGanTrainer on the tree (bf16, batch 16, 4
   K1 + 4 K2 launches a step) and DamsmTrainer on the tree (bf16, batch
   48), each beside its synthetic step of phase 5; sampling() on the
   tree's test captions writing PNGs, then ``python -m
   t2igan_torch.fid_score`` and ``python -m t2igan_torch.inception_score``
   on the card (random Inception weights).

8. (after phase 7) the rest of the model surface: ``GAN.B_DCGAN`` at the
   widths of eval_clip_bird.yml (a seeded GDCGan's ``G_DCGAN``
   ``netG_epoch_0.pth`` read back through ``TRAIN.NET_G``; the f32
   sampler on the card against the CPU within 1e-4 and the bf16 gap;
   ``sampling()`` one round in both tail settings, 2 K1 and 2 or 0 K3
   launches per sampler call; the sampler timed at batch 128 in bf16,
   both tails); the attention grid of the committed fixture against the
   sha256 of the JAX package's PIL grid and ``gen_example``'s
   ``<s>_a<k>.png``; the legacy encoders (RnnEncoder LSTM and GRU,
   CnnEncoder, GlobalAttentionText) at the reference's widths, card
   against CPU, timed.

9. (after phase 8) data and tensor parallelism on the one card.  NCCL
   refuses two ranks on one card, so the multi-rank runs use gloo with
   both ranks on cuda:0 (``t2igan_torch.parallel.mesh.spawn_local``), and
   NCCL runs at world size 1: (9a) ``python -m torch.distributed.run
   --nproc_per_node 1 -m t2igan_torch.train_gan`` at clip_bird_dmgan.yml's
   full width, 3 bf16 steps, 4 K1 + 4 K2 launches a step; the f32 step
   under a one-rank NCCL group bitwise equal to the step without a group
   (deterministic algorithms); (9b) two ranks: the f32 GAN step over a
   global batch of 4 against one process on the same 4 rows from the
   ranks' weights (after SGD lr 0.01: metrics 1e-4 relative; every
   parameter and buffer within 1e-4 + 1e-4 |x|, a parameter within 1e-3
   of its module's largest change), the ranks' states bitwise
   equal after 3 steps, 4 K1 + 4 K2 per rank per step, and the f32 DAMSM
   loss and gradients at damsm/bird.yml's width against one process (the
   CPU test's bounds); (9c) ``sampling()`` over two ranks in both tails:
   the one-process sweep's hits, R and PNG names, pixels within 1;
   (9d) ViT-B/32 tensor-parallel over the two ranks against the
   replicated CLIP; (9e) the bf16 step at batch 16 with and without the
   one-rank NCCL group, in turns, and the two-rank gloo step, timed.

It ends with a ``{"kernels": [...]}`` line (K1's, K2's and the BN
kernels' ``launches``: those of a replayed step of phase 4's trainer, by
name in its trace), the card line and, last,
``{"ok": true, "device": {...}}``.  Any failure raises, and the process
exits non-zero; without a CUDA card it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import pickle
import re
import subprocess
import sys
import time

CAPTIONS = [
    "this bird has a red crown and a short pointed beak",
    "a small yellow bird with black wings and a white belly",
    "the bird is brown with white spots on its chest",
    "a blue bird with a long tail perched on a branch",
    "this small bird has grey wings, an orange breast and a black head",
    "a black bird with a bright red patch on its wing",
    "a bird with a white head, a yellow bill and dark brown wings",
    "this is a green bird with a curved beak",
]

# H100 SXM data-sheet peaks: device memory rate, dense bf16 and TF32
# tensor-core rates, f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}

# memory read: batch of the timed sampler, of the timed train step, and
# the two refinement stages.
TIMED_BATCH = 128
TRAIN_BATCH = 16
STAGE_HW = ((64, 64), (128, 128))
SLOTS, CHANNELS = 77, 64
F32_UNIT = 2.0 ** -24  # unit roundoff of f32
BF16_STEP = 2.0 ** -7  # one bf16 step, relative to the leading bit

# K3 checks: (batch, (H, W), C, R, RGB head, want_h, BN shift added).  The
# sampler's two stage shapes at batch 16 (64^2 with the feature output,
# 128^2 with the RGB head only, and with both), then the edges.
TAIL_CHANNELS = 2 * CHANNELS
RESCHAIN_CASES = [(16, (64, 64), TAIL_CHANNELS, 2, False, True, 0.0),
                  (16, (128, 128), TAIL_CHANNELS, 2, True, False, 0.0),
                  (16, (128, 128), TAIL_CHANNELS, 2, True, True, 0.0),
                  (2, (32, 32), TAIL_CHANNELS, 1, False, True, 0.0),
                  (2, (32, 32), TAIL_CHANNELS, 3, True, True, 0.0),
                  (2, (17, 19), TAIL_CHANNELS, 2, True, True, 0.0),
                  (2, (16, 16), 16, 2, True, True, 0.0),
                  (1, (64, 64), TAIL_CHANNELS, 2, False, True, 0.0),
                  (2, (16, 16), TAIL_CHANNELS, 2, False, True, 3.0),
                  # Tile edges of the bf16 kernels (tile_geometry): 96x40
                  # (8-wide patches), 24x100 (the last patch ragged), H = 1
                  # (one 128-wide patch, half outside), batch 1 at the
                  # last stage with the head.
                  (2, (96, 40), TAIL_CHANNELS, 2, True, True, 0.0),
                  (2, (24, 100), TAIL_CHANNELS, 1, True, True, 0.0),
                  (4, (1, 64), TAIL_CHANNELS, 1, True, True, 0.0),
                  (1, (128, 128), TAIL_CHANNELS, 2, True, True, 0.0),
                  # C = 256: two N tiles in every conv.
                  (2, (16, 16), 2 * TAIL_CHANNELS, 1, True, True, 0.0),
                  # C = 48: an odd count of the f32 kernels' 16-channel K
                  # slices a tap, and a ragged last head slice (C/2 = 24).
                  (2, (16, 16), 48, 1, True, True, 0.0)]


# (batch, HW, C, L) of the kernel checks: the paths' shapes at batch 16,
# the small generator's width (GF_DIM 32), then the edges of what the
# kernels take (L = 1 and 128, C = 4 and 128, C % 8 != 0, odd HW).
KERNEL_CASES = [(16, hw, CHANNELS, SLOTS) for hw in STAGE_HW + ((17, 19),)]
KERNEL_CASES += [(16, STAGE_HW[0], 32, SLOTS), (3, (5, 7), 4, 1),
                 (2, (33, 9), 36, 33), (2, (16, 16), 128, 128)]


def ptxas_kernels(log):
    """(kernel, registers, spill-store bytes) per entry of a ptxas -v log,
    the kernel named by its identifier and template integers
    (``conv_tc<0,256>``)."""
    out, name, spills = [], None, 0
    for line in log:
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            # _ZN<len><namespace><len><identifier>[I<Li<n>E>...E]...
            sym = m.group(1)
            parts = []
            rest = sym[3:] if sym.startswith("_ZN") else sym[2:]
            while len(parts) < 2 and re.match(r"\d+", rest):
                n = re.match(r"\d+", rest)
                parts.append(rest[n.end():n.end() + int(n.group())])
                rest = rest[n.end() + int(n.group()):]
            name = parts[-1] if parts else sym
            args = re.match(r"I((?:Li\d+E)+)E", rest)
            if args:
                name += "<" + ",".join(re.findall(r"Li(\d+)E",
                                                  args.group(1))) + ">"
            spills = 0
        elif "bytes spill stores" in line:
            spills = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in line and "registers" in line and name:
            out.append((name, int(line.split("Used")[1].split()[0]), spills))
            name = None
    return out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls,
    between two CUDA events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# The device kernels behind each count of ``LAUNCHES`` and
# ``batchnorm.BN_LAUNCHES`` (K1 and K2 of either precision), by a part of
# their names, mangled or not; K2's launch runs its reduce kernel too.
KERNEL_NAMES = (
    ("memory_read_fwd", ("memory_read_fwd_tc_kernel",
                         "memory_read_fwd_f32_kernel")),
    ("memory_read_bwd", ("memory_read_bwd_tc_kernel",
                         "memory_read_bwd_f32_kernel")),
    ("memory_read_bwd_reduce", ("memory_read_bwd_reduce",)),
    ("stats", ("bn_fw_stats_kernel",)), ("apply", ("bn_fw_apply_kernel",)),
    ("bwd_reduce", ("bn_bw_reduce_kernel",)), ("bwd_dx", ("bn_bw_dx_kernel",)))


def profiled_launches(fn) -> tuple:
    """``fn()`` once under torch.profiler: the K1, K2 and BN kernels the
    card ran, counted by name in the trace, as a dict in the keys of
    ``LAUNCHES`` and one in those of ``BN_LAUNCHES``: what the card ran,
    where the counters hold what a replayed graph's capture recorded.
    Raises where a K2 tile kernel ran without its reduce."""
    from t2igan_torch.profile_step import trace_kernels

    _, kernels = trace_kernels(fn, 1, cpu=False)
    counts = {key: sum(any(n in e["name"] for n in names) for e in kernels)
              for key, names in KERNEL_NAMES}
    if counts.pop("memory_read_bwd_reduce") != counts["memory_read_bwd"]:
        raise AssertionError("a K2 launch ran without its reduce kernel")
    bn = ("stats", "apply", "bwd_reduce", "bwd_dx")
    return ({k: v for k, v in counts.items() if k not in bn},
            {k: counts[k] for k in bn})


def replay_kernels(name: str) -> tuple:
    """A bf16 ``CondGanTrainer`` at the full width of ``name`` and its
    YAML's batch takes 3 steps (eager, then the capture of the step's CUDA
    graphs, then a replay); the replay runs under torch.profiler.  Returns
    :func:`profiled_launches`' counts of it."""
    import torch

    from t2igan_torch.train import graphs
    from t2igan_torch.train.train_gan import CondGanTrainer

    trainer = CondGanTrainer(fused_cfg(True, name), "cuda", torch.bfloat16,
                             seed=0)
    trainer.train_steps(2)
    runs = graphs.GAN_GRAPHS.copy()
    counts = profiled_launches(lambda: trainer.train_steps(1))
    if graphs.GAN_GRAPHS - runs != {"replay": 1}:
        raise AssertionError("the profiled step was no replay: GAN_GRAPHS "
                             f"{dict(graphs.GAN_GRAPHS)}")
    return counts


def replay_kernels_apart(name: str) -> tuple:
    """:func:`replay_kernels` in a process of its own, whose first profiler
    session it is: profiling the graphs in this process left a later
    session here (phase 5e's) tracing no kernel."""
    proc = subprocess.run(
        [sys.executable, "-c", "import json, sys, chip_smoke as c; "
         "print(json.dumps(c.replay_kernels(sys.argv[1])))", name],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError("replay_kernels failed:\n" + proc.stderr[-3000:])
    return tuple(json.loads(proc.stdout.strip().splitlines()[-1]))


def queued_ms(fn, iters: int, warmup: int = 3):
    """Mean device time of ``fn`` in ms and mean host time of a call in µs,
    over ``iters`` calls queued behind a sleep kernel, after ``warmup``
    calls.  The card reaches the first call only once the host has queued
    the last (the sleep is lengthened until it has), so it runs them back
    to back and the device time is the kernels' own, not the host's."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 1 << 25  # ~20 ms at the H100's clock
    for _ in range(5):
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host = time.perf_counter() - t0
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / iters, host / iters * 1e6
        cycles *= 4
    raise RuntimeError("the card reached the timed calls before the host "
                       "had queued them: does the call synchronize?")


def f32_bound(nbytes, flops):
    """The least time (ms) an f32 function may take on the card: the larger
    of its bytes over the memory rate and its f32 work done as 3xTF32 (three
    TF32 products for each f32 one) over the TF32 peak, the cheapest way
    the card has to do f32 products at f32 accuracy.  Also returns the
    bytes and 3xTF32 times and the CUDA-core floor (the f32 work over the
    67 TFLOP/s outside the tensor cores), which a tensor-core kernel may
    beat."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * flops / PEAK_FLOPS["tf32"] * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops, flops / PEAK_FLOPS["f32"] * 1e3


def f32_bound_text(nbytes, flops):
    bound, t_bytes, t_ops, t_cuda = f32_bound(nbytes, flops)
    return (f"bound {bound:.4f} ms (bytes {nbytes / 1e6:.1f} MB -> "
            f"{t_bytes:.4f} ms, {flops / 1e9:.2f} GFLOP as 3xTF32 -> "
            f"{t_ops:.4f} ms; CUDA-core floor {t_cuda:.4f} ms)")


def dtype_name(dtype) -> str:
    """"bf16" or "f32", as the timing lines name the dtype."""
    return "bf16" if str(dtype) == "torch.bfloat16" else "f32"


def add_row(rows, key, **vals):
    """Add the times in ``vals`` to ``rows[key]`` (phase 5g's f32 rows sum
    a kernel's two stage shapes); a value that is not a float is set."""
    row = rows.setdefault(key, {})
    for name, val in vals.items():
        row[name] = row.get(name, 0.0) + val if isinstance(val, float) else val


def memory_read_inputs(b, hw, dtype, mask, seed, slots=SLOTS,
                       channels=CHANNELS):
    """q [b, h, w, C], k/v [b, L, C] in ``dtype`` and a pad mask: random
    lengths with the last row fully padded ("ragged"), or None ("none")."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    h, w = hw
    q = torch.randn((b, h, w, channels), generator=g, device="cuda")
    k = torch.randn((b, slots, channels), generator=g, device="cuda")
    v = torch.randn((b, slots, channels), generator=g, device="cuda")
    pad = None
    if mask == "ragged":
        lens = torch.randint(min(3, slots), slots + 1, (b,), generator=g,
                             device="cuda")
        pad = torch.arange(slots, device="cuda")[None, :] >= lens[:, None]
        pad[-1] = True
    return q.to(dtype), k.to(dtype), v.to(dtype), pad


def check_memory_read(results):
    """Phase 2: K1 against memory_read_plain on the card."""
    import torch

    from t2igan_torch.ops.kernels.memory_read import (fwd_bf16_bound,
                                                      fwd_f32_bound,
                                                      memory_read_fused,
                                                      memory_read_plain,
                                                      read_f64)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = 0.0
    seed = 0
    for dtype in (torch.float32, torch.bfloat16):
        for b, hw, c, slots in KERNEL_CASES:
            for mask in ("ragged", "none"):
                seed += 1
                q, k, v, pad = memory_read_inputs(b, hw, dtype, mask, seed,
                                                  slots, c)
                out = memory_read_fused(q, k, v, pad).float()
                ref = memory_read_plain(q, k, v, pad).float()
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                exact = read_f64(q, k, v, pad)
                vs64 = ((out - exact).abs().max().item(),
                        (ref - exact).abs().max().item())
                ok = bool(torch.isfinite(out).all())
                if dtype == torch.float32:
                    # 3e-6 C: C-term f32 dot products of unit normals
                    # (logits of size ~sqrt(C)) summed in another order
                    # than cuBLAS, each term 3xTF32 in K1.
                    tol = fwd_f32_bound(c)
                    tol64 = None
                else:
                    # K1 rounds the attention to bf16 before p.v, as the
                    # TPU kernel does, then its output; the plain version
                    # rounds only its output.  fwd_bf16_bound derives the
                    # bound from those rounding points, against the plain
                    # version and against the exact read.
                    tol = fwd_bf16_bound(q, k, v, pad, against_plain=True)
                    tol64 = fwd_bf16_bound(q, k, v, pad)
                    ok &= vs64[0] <= tol64
                ok &= err <= tol
                print(f"check memory_read_fwd {str(dtype)[6:]} B={b} "
                      f"HW={hw[0]}x{hw[1]} C={c} L={slots} mask={mask}:"
                      f" max_abs_err={err:.3e} tol={tol:.3e} "
                      f"{'ok' if ok else 'FAIL'} (vs float64: kernel "
                      f"{vs64[0]:.3e}"
                      + ("" if tol64 is None else f"/{tol64:.3e}")
                      + f", plain {vs64[1]:.3e})")
                if not ok:
                    raise AssertionError("memory_read kernel disagrees with "
                                         "memory_read_plain")
                worst = max(worst, err)
    results["memory_read_fwd"]["max_abs_err"] = worst


def check_memory_read_bwd(results):
    """Phase 2b: K2 against memory_read_bwd_plain on the card, its zeros
    at padding and its determinism; MemoryRead against autograd through
    memory_read_plain."""
    import torch

    from t2igan_torch.ops.kernels.memory_read import (MemoryRead,
                                                      bwd_bf16_bound,
                                                      bwd_f32_bounds,
                                                      grads_f64,
                                                      memory_read_bwd,
                                                      memory_read_bwd_plain,
                                                      memory_read_plain)

    worst = 0.0
    seed = 100
    names = ("dq", "dk", "dv")
    for dtype in (torch.float32, torch.bfloat16):
        for b, hw, c, slots in KERNEL_CASES:
            for mask in ("ragged", "none"):
                seed += 1
                q, k, v, pad = memory_read_inputs(b, hw, dtype, mask, seed,
                                                  slots, c)
                g = torch.Generator(device="cuda").manual_seed(seed)
                dout = torch.randn(q.shape, generator=g,
                                   device="cuda").to(dtype)
                out = memory_read_bwd(q, k, v, pad, dout)
                again = memory_read_bwd(q, k, v, pad, dout)
                ref = memory_read_bwd_plain(q, k, v, pad, dout)
                torch.cuda.synchronize()
                exact = grads_f64(q, k, v, pad, dout)[0]
                if dtype == torch.float32:
                    # Recursive f32 sums of n terms are off by at most
                    # n * 2^-24 times the sum of the terms' magnitudes;
                    # n is L for dq and HW for dk/dv, plus the C- and
                    # L-term sums inside each term.
                    tols = bwd_f32_bounds(q, k, v, pad, dout)
                    tols64 = [math.inf] * 3
                else:
                    # K2 rounds P and ds to bf16 before the three products
                    # that take them, then its outputs; the plain version
                    # rounds only its outputs.  bwd_bf16_bound derives the
                    # bounds from those rounding points (2^-8 of each
                    # output's sum of |terms| plus one output rounding),
                    # against the plain version and against float64.
                    tols = bwd_bf16_bound(q, k, v, pad, dout,
                                          against_plain=True)
                    tols64 = bwd_bf16_bound(q, k, v, pad, dout)
                line = []
                ok = True
                for name, o, r, e, tol, tol64 in zip(names, out, ref, exact,
                                                     tols, tols64):
                    err = (o.float() - r.float()).abs().max().item()
                    e_k = (o.double() - e).abs().max().item()
                    e_p = (r.double() - e).abs().max().item()
                    ok &= (bool(torch.isfinite(o).all()) and err <= tol
                           and e_k <= tol64)
                    worst = max(worst, err)
                    line.append(f"{name} {err:.3e}/{tol:.3e} (vs float64: "
                                f"kernel {e_k:.3e}"
                                + ("" if tol64 == math.inf
                                   else f"/{tol64:.3e}")
                                + f", plain {e_p:.3e})")
                same = all(torch.equal(x, y) for x, y in zip(out, again))
                zero = True
                if pad is not None:
                    has_real = ~pad.all(dim=1)
                    zero = (bool((out[1][pad] == 0).all())
                            and bool((out[2][has_real][pad[has_real]]
                                      == 0).all()))
                print(f"check memory_read_bwd {str(dtype)[6:]} B={b} "
                      f"HW={hw[0]}x{hw[1]} C={c} L={slots} mask={mask}: "
                      f"err/tol {', '.join(line)}; zero dk/dv at padding "
                      f"{zero}; run-to-run identical {same} "
                      f"{'ok' if ok and zero and same else 'FAIL'}")
                if not (ok and zero and same):
                    raise AssertionError("memory_read backward kernel "
                                         "disagrees with its plain version")

    # The autograd pairing at the 128x128 stage shape, f32.
    q, k, v, pad = memory_read_inputs(TRAIN_BATCH, STAGE_HW[1],
                                      torch.float32, "ragged", 7)
    dout = torch.randn(q.shape, device="cuda")
    tols = bwd_f32_bounds(q, k, v, pad, dout)
    grads = []
    for fn in (MemoryRead.apply, memory_read_plain):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        (fn(*leaves, pad) * dout).sum().backward()
        grads.append([t.grad for t in leaves])
    errs = [(a - r).abs().max().item() for a, r in zip(*grads)]
    ok = all(e <= t for e, t in zip(errs, tols))
    print("check MemoryRead autograd vs autograd of memory_read_plain, f32 "
          f"B={TRAIN_BATCH} HW=128x128: "
          + ", ".join(f"{n} {e:.3e}/{t:.3e}"
                      for n, e, t in zip(names, errs, tols))
          + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("MemoryRead gradients disagree with autograd")
    results["memory_read_bwd"]["max_abs_err"] = worst


def reschain_inputs(b, hw, c, n_res, rgb, dtype, seed, shift=0.0):
    """K3 arguments on the card: x [b, h, w, c] ~ N(0, 1), kernels HWIO of
    unit gain (std 1/sqrt(fan in)) in ``dtype``, BN scales 1 + 0.1 N and
    shifts 0.1 N (+ ``shift`` in the residual blocks) in f32."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def t(*shape, std=1.0):
        return torch.randn(shape, generator=g, device="cuda") * std

    ws = (9 * c) ** -0.5
    x = t(b, hw[0], hw[1], c).to(dtype)
    rb = [(t(3, 3, c, 2 * c, std=ws).to(dtype), 1 + 0.1 * t(2 * c),
           0.1 * t(2 * c) + shift, t(3, 3, c, c, std=ws).to(dtype),
           1 + 0.1 * t(c), 0.1 * t(c) + shift) for _ in range(n_res)]
    up = (t(3, 3, c, c, std=ws).to(dtype), 1 + 0.1 * t(c), 0.1 * t(c))
    head = t(3, 3, c // 2, 3, std=(4.5 * c) ** -0.5).to(dtype) if rgb else None
    return x, rb, up, head


def tail_modules(c, n_res, rgb, dtype, seed):
    """The port's eval module chain of a stage tail (ResBlocks, UpBlock,
    the RGB head) with weights from a seed and random running statistics,
    on the card in ``dtype``, and a function that runs it on NCHW maps."""
    import torch

    from t2igan_torch.models.generator import (BatchNorm, GetImageG,
                                               ResBlock, UpBlock,
                                               init_generator_)

    mods = torch.nn.ModuleList([ResBlock(c) for _ in range(n_res)]
                               + [UpBlock(c, c // 2)]
                               + ([GetImageG(c // 2)] if rgb else []))
    rng = torch.Generator().manual_seed(seed)
    init_generator_(mods, rng)
    with torch.no_grad():
        for m in mods.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0.0, 0.1, generator=rng)
                m.running_var.uniform_(0.5, 2.0, generator=rng)
    mods = mods.to("cuda", dtype, memory_format=torch.channels_last).eval()

    def chain(h):
        for m in mods[:n_res + 1]:
            h = m(h)
        return mods[-1](h) if rgb else h

    return mods, chain


def _outputs(out):
    return [o.float() for o in (out if isinstance(out, tuple) else (out,))]


def check_reschain(results):
    """Phase 2c: K3 against resblock_chain_up_plain on the card in f32
    (TF32 off) and bf16, at the stage shapes and the edges; then K3 on
    folded module weights against the eval module chain."""
    import torch

    from t2igan_torch.ops.kernels.reschain import (f32_tol,
                                                   resblock_chain_up_fused)

    results["reschain"]["max_abs_err"] = check_reschain_cases(
        RESCHAIN_CASES)

    # Folded module weights through K3 against the eval module chain, f32,
    # at the last stage's shape: one bound covers fold and kernel.
    mods, chain = tail_modules(TAIL_CHANNELS, 2, True, torch.float32, 9)
    x, _, _, _ = reschain_inputs(4, STAGE_HW[1], TAIL_CHANNELS, 2, False,
                                 torch.float32, 9)
    with torch.no_grad():
        want = chain(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        got = resblock_chain_up_fused(
            x, [m.fold() for m in mods[:2]], *mods[2].fold(),
            rgb_kernel=mods[3].fold(), want_h=False)
    err = (got - want).abs().max().item()
    tol = f32_tol(TAIL_CHANNELS, 1.0)  # images in [-1, 1]
    print(f"check reschain f32 on folded weights vs the eval module chain, "
          f"B=4 HW={STAGE_HW[1][0]}x{STAGE_HW[1][1]} C={TAIL_CHANNELS} R=2 "
          f"rgb: max_abs_err="
          f"{err:.3e} tol={tol:.3e} {'ok' if err <= tol else 'FAIL'}")
    if not err <= tol:
        raise AssertionError("K3 on folded weights disagrees with the "
                             "module chain")


def check_reschain_cases(cases, seed=200) -> float:
    """K3 against resblock_chain_up_plain on the card in f32 (TF32 off)
    and bf16 at each of ``cases`` (``RESCHAIN_CASES``' layout); returns
    the largest f32 error."""
    import torch

    from t2igan_torch.ops.kernels.reschain import (f32_f64_tol, f32_tol,
                                                   resblock_chain_up_fused,
                                                   resblock_chain_up_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for i, (b, hw, c, n_res, rgb, want_h, shift) in enumerate(cases):
            x, rb, up, head = reschain_inputs(b, hw, c, n_res, rgb, dtype,
                                              seed + i, shift)
            out = _outputs(resblock_chain_up_fused(x, rb, *up, head, want_h))
            ref = _outputs(resblock_chain_up_plain(x, rb, *up, head, want_h))
            if dtype == torch.bfloat16:
                # The same bf16 values through the plain version in f32:
                # how far each bf16 version is from its exact result.
                f32 = _outputs(resblock_chain_up_plain(
                    x.float(), [[a.float() for a in p] for p in rb],
                    *[a.float() for a in up],
                    None if head is None else head.float(), want_h))
            else:
                # The tail in float64, for the stricter f32 check.
                f64 = _outputs(resblock_chain_up_plain(
                    x.double(), [[a.double() for a in p] for p in rb],
                    *[a.double() for a in up],
                    None if head is None else head.double(), want_h))
            torch.cuda.synchronize()
            line, ok = [], True
            for name, o, r in zip(("up", "rgb") if want_h else ("rgb",),
                                  out, ref):
                err = (o - r).abs().max().item()
                scale = r.abs().max().item()
                ok &= bool(torch.isfinite(o).all())
                if dtype == torch.float32:
                    # Worst-case f32 rounding of a 9C-term sum, about five
                    # convs deep, times the largest output; and, stricter,
                    # against float64 (f32_f64_tol: what tells 3xTF32
                    # from one TF32 product at C = 128).
                    tol = f32_tol(c, scale)
                    e = f64[len(line)]
                    e_k = (o.double() - e).abs().max().item()
                    e_p = (r.double() - e).abs().max().item()
                    tol64 = f32_f64_tol(e_p, c, scale)
                    ok &= err <= tol and e_k <= tol64
                    worst = max(worst, err)
                    line.append(f"{name} {err:.3e}/{tol:.3e}, vs f64 "
                                f"{e_k:.3e}/{tol64:.3e} (plain {e_p:.3e})")
                else:
                    # K3 rounds where the Pallas kernel does, the plain
                    # version also rounds each conv output to bf16: K3
                    # must be no farther from the f32 result than twice
                    # the plain version's distance plus half a step.
                    e = f32[len(line)]
                    e_k = (o - e).abs().max().item()
                    e_p = (r - e).abs().max().item()
                    tol = 2 * e_p + BF16_STEP / 2 * scale
                    ok &= e_k <= tol
                    line.append(f"{name} vs f32 {e_k:.3e}/{tol:.3e} (plain "
                                f"{e_p:.3e}), vs plain {err:.3e} = "
                                f"{err / (BF16_STEP * scale):.2f} bf16 steps")
            print(f"check reschain {str(dtype)[6:]} B={b} HW={hw[0]}x{hw[1]} "
                  f"C={c} R={n_res} rgb={rgb} want_h={want_h} shift={shift}:"
                  f" {'; '.join(line)} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("reschain kernel disagrees with "
                                     "resblock_chain_up_plain")
    return worst


def bn_shapes(b=TRAIN_BATCH, gf_dim=64, r_num=2, stages=2):
    """(name, input shape, epilogue) of the train-mode BNs of one G forward
    at clip_bird_dmgan.yml's widths: InitStageG's fc BN and 4 UpBlocks,
    then each stage's ResBlocks (bn1 + GLU, bn2 + residual) and UpBlock."""
    ngf = gf_dim * 16
    out = [("init.fc", (b, ngf * 32), "glu")]
    out += [(f"init.up{i}", (b, ngf >> i, 8 << i, 8 << i), "glu")
            for i in range(4)]
    for s in range(stages):
        side = 64 << s
        for r in range(r_num):
            out += [(f"s{s + 1}.res{r}.bn1", (b, 4 * gf_dim, side, side),
                     "glu"),
                    (f"s{s + 1}.res{r}.bn2", (b, 2 * gf_dim, side, side),
                     "residual")]
        out.append((f"s{s + 1}.up", (b, 2 * gf_dim, 2 * side, 2 * side),
                    "glu"))
    return out


def check_batchnorm(card, results, iters=3):
    """Phase 2b: the train-mode BN kernels (csrc/batchnorm.cu) against their
    plain stages on the card at the 15 BN shapes of the train cell's G
    forward (batch 16), bf16 and f32: outputs, running statistics, the
    four gradients through ``BatchNormTrain`` against the plain stages
    composed the same way, and a clean ``cudaGetLastError``; then each
    shape's device time (forward: stats + apply; backward: sums + dx)
    beside the least bytes a fused layer moves (x read once) and the
    plain stages' time.  A step runs each shape twice (two G forwards)."""
    import torch

    from t2igan_torch.ops.kernels import batchnorm as kbn

    worst = 0.0
    totals = {}
    failures = []
    for dtype in (torch.bfloat16, torch.float32):
        name = dtype_name(dtype)
        e = 2 if dtype == torch.bfloat16 else 4
        tot = totals.setdefault(name, {"fw": 0.0, "bw": 0.0, "plain": 0.0,
                                       "bound": 0.0, "host_us": 0.0})
        for i, (label, shape, epi) in enumerate(bn_shapes()):
            g = torch.Generator(device="cuda").manual_seed(300 + i)
            c = shape[1]
            fmt = (torch.channels_last if len(shape) == 4
                   else torch.contiguous_format)

            def rand(*s, scale=1.0, shift=0.0):
                return (torch.randn(s, generator=g, device="cuda") * scale
                        + shift)

            # Per-channel scale in [0.5, 1.5], shift N(0, 1): a batch
            # variance well above the f32 rounding of E[x^2] - mean^2.
            per_channel = [1, c] + [1] * (len(shape) - 2)
            x = (rand(*shape) * (torch.rand(per_channel, generator=g,
                                            device="cuda") + 0.5)
                 + rand(*per_channel))
            x[:, 0] = 0.75  # a constant channel: the clamp
            x = x.to(dtype).contiguous(memory_format=fmt)
            weight = rand(c, scale=0.1, shift=1.0)
            bias = rand(c, scale=0.1)
            res = (rand(*shape).to(dtype).contiguous(memory_format=fmt)
                   if epi == "residual" else None)
            glu = epi == "glu"
            out_shape = ((shape[0], c // 2) + tuple(shape[2:]) if glu
                         else shape)
            dout = rand(*out_shape).to(dtype).contiguous(memory_format=fmt)
            got, want = {}, {}
            for side, store in (("kernel", got), ("plain", want)):
                rm = torch.zeros(c, device="cuda")
                rv = torch.ones(c, device="cuda")
                xs = x.clone().requires_grad_(True)
                w = weight.clone().requires_grad_(True)
                bb = bias.clone().requires_grad_(True)
                rs = None if res is None else res.clone().requires_grad_(True)
                if side == "kernel":
                    y = kbn.batch_norm_train(xs, w, bb, rm, rv, 1e-5, glu=glu,
                                             residual=rs)
                    grads = torch.autograd.grad(
                        y, [xs, w, bb] + ([rs] if rs is not None else []),
                        dout)
                else:
                    rows = kbn.as_rows(xs.detach())
                    st = kbn.forward_stats_plain(rows)
                    y = kbn.from_rows(kbn.forward_apply_plain(
                        rows, st, w.detach(), bb.detach(), rm, rv, 1e-5, glu,
                        None if rs is None else kbn.as_rows(rs.detach())), xs)
                    d = kbn.as_rows(dout)
                    sums, dw, db = kbn.backward_sums_plain(
                        rows, d, st, w.detach(), bb.detach(), 1e-5, glu)
                    dx = kbn.from_rows(kbn.backward_dx_plain(
                        rows, d, st, w.detach(), bb.detach(), sums, 1e-5,
                        rows.shape[0], glu), xs)
                    grads = [dx, dw, db] + ([dout] if rs is not None else [])
                store.update(out=y.detach().float(), running_mean=rm,
                             running_var=rv, dx=grads[0].float(),
                             dweight=grads[1], dbias=grads[2])
                if rs is not None:
                    store["dresidual"] = grads[3].float()
            torch.cuda.synchronize()
            err = kbn.last_error()
            if err != 0:
                raise RuntimeError(f"batchnorm {label} {name}: "
                                   f"cudaGetLastError {err}")
            line = []
            for key in want:
                a, r = got[key], want[key]
                diff = (a - r).abs()
                scale = r.abs().max().item() + 1e-12
                # Sums over up to 2^20 rows in another order: 1e-4 of the
                # largest entry (f32 sums of 2^20 terms of either sign move
                # by ~1e-5 of it; a wrong kernel by 1e-2 or more); and a
                # flip of the last bf16 bit where the two f32 values round
                # to neighbours (outputs, dx in bf16).
                tol = 1e-4 * scale + (BF16_STEP * r.abs()
                                      if dtype == torch.bfloat16 and key in
                                      ("out", "dx", "dresidual") else 0.0)
                bad = (diff > tol).sum().item()
                rel = diff.max().item() / scale
                if dtype == torch.float32:
                    worst = max(worst, diff.max().item())
                line.append(f"{key} {rel:.2e}{'' if bad == 0 else ' FAIL'}")
                if bad:
                    failures.append(f"batchnorm {label} {name} {key}: {bad} "
                                    f"entries beyond the bound, largest "
                                    f"{diff.max().item():.3e}")
            # Times (device, queued behind a sleep; host a call).
            rows = kbn.as_rows(x)
            d = kbn.as_rows(dout)
            rsr = None if res is None else kbn.as_rows(res)
            rm = torch.zeros(c, device="cuda")
            rv = torch.ones(c, device="cuda")
            st = kbn.forward_stats(rows)
            sums = kbn.backward_sums(rows, d, st, weight, bias, 1e-5, glu)[0]
            fw, host = queued_ms(lambda: kbn.forward_apply(
                rows, kbn.forward_stats(rows), weight, bias, rm, rv, 1e-5,
                glu, rsr), iters)
            bw, _ = queued_ms(lambda: kbn.backward_dx(
                rows, d, st, weight, bias,
                kbn.backward_sums(rows, d, st, weight, bias, 1e-5, glu)[0],
                1e-5, rows.shape[0], glu), iters)
            plain, _ = queued_ms(lambda: (kbn.forward_apply_plain(
                rows, kbn.forward_stats_plain(rows), weight, bias, rm, rv,
                1e-5, glu, rsr), kbn.backward_dx_plain(
                rows, d, st, weight, bias, sums, 1e-5, rows.shape[0], glu),
                kbn.backward_sums_plain(rows, d, st, weight, bias, 1e-5,
                                        glu)), iters)
            n = x.numel()
            # Least bytes of a fused layer, x read once a direction: GLU
            # x + out forward, x + dout + dx backward; residual x + res +
            # out, x + dout + dx.
            nbytes = e * n * ((1.5 + 2.5) if glu else (3 + 3))
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            for k, v in (("fw", fw), ("bw", bw), ("plain", plain),
                         ("bound", bound)):
                tot[k] += 2 * v
            tot["host_us"] += host
            print(f"[{card}] batchnorm {name} {label} {tuple(shape)} {epi}: "
                  f"kernel fw {fw:.4f} + bw {bw:.4f} ms (host {host:.1f} us a "
                  f"forward), plain {plain:.4f} ms, bound {bound:.4f} ms "
                  f"({nbytes / 1e6:.1f} MB), {bound / (fw + bw):.1%} of bound; "
                  f"max rel gap " + ", ".join(line))
            del x, dout, res, got, want, rows, d
        print(f"[{card}] batchnorm {name}, a train step's 30 BNs (b16): "
              f"kernel fw {tot['fw']:.3f} + bw {tot['bw']:.3f} = "
              f"{tot['fw'] + tot['bw']:.3f} ms, plain {tot['plain']:.3f} ms, "
              f"bound {tot['bound']:.3f} ms (bytes), "
              f"{tot['bound'] / (tot['fw'] + tot['bw']):.1%} of bound; host "
              f"{tot['host_us'] / 15:.1f} us a forward (stats + apply)")
    if failures:
        raise RuntimeError("; ".join(failures))
    bf = totals["bf16"]
    results["batchnorm"].update(
        max_abs_err=worst,
        ms=bf["fw"] + bf["bw"], plain_ms=bf["plain"], bound_ms=bf["bound"],
        bound_by="bytes", library_ms=None)


def drive_sampler(name="eval_clip_bird.yml"):
    """Phase 3 (10a with ``eval_clip_coco.yml``): the sampler at the full
    width of the config ``name`` through the generate entry point."""
    import torch

    from t2igan_torch.generate import build_models, generate
    from t2igan_torch.ops.kernels import LAUNCHES
    from t2igan_torch.train.steps import make_sampler

    cfg = fused_cfg(False, name)
    batch = cfg.TRAIN.BATCH_SIZE
    captions = [CAPTIONS[i % len(CAPTIONS)] for i in range(2 * batch)]
    out_dir = os.path.join("output", "chip_smoke", name[:-4])
    calls = -(-len(captions) // batch)

    for kernel in list(LAUNCHES):
        LAUNCHES[kernel] = 0
    t0 = time.perf_counter()
    images = generate(cfg, captions, out_dir, batch, torch.bfloat16, seed=0,
                      device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = LAUNCHES["memory_read_fwd"]
    print(f"sampler path: generate, {name} (R_NUM {cfg.GAN.R_NUM}), "
          f"{len(captions)} captions, batch {batch}, "
          f"bf16, {calls} sampler calls, {seconds:.2f} s with model set-up; "
          f"launches {dict(LAUNCHES)}")
    if launches != 2 * calls or LAUNCHES["memory_read_bwd"] != 0:
        raise AssertionError(f"expected 2 memory_read_fwd launches per "
                             f"sampler call and no backward, got "
                             f"{dict(LAUNCHES)} in {calls} calls")
    for fakes in images:
        shapes = [tuple(f.shape) for f in fakes]
        if shapes != [(batch, s, s, 3) for s in (64, 128, 256)]:
            raise AssertionError(f"image shapes {shapes}")
        for f in fakes:
            if not (torch.isfinite(f).all() and f.abs().max() <= 1.0):
                raise AssertionError("images not finite in [-1, 1]")
    pngs = len([n for n in os.listdir(out_dir) if n.endswith(".png")])
    if pngs < 3 * len(captions):
        raise AssertionError(f"{pngs} PNGs written")

    # f32 on the card (K1) against the same sampler on the CPU (plain).
    from t2igan_torch.data.tokenizer import ClipTokenizer

    tok = ClipTokenizer.load()(CAPTIONS[:2], max_length=cfg.TEXT.WORDS_NUM)
    noise = torch.Generator().manual_seed(5)
    z = torch.randn((2, cfg.GAN.Z_DIM), generator=noise)
    eps = torch.randn((2, cfg.GAN.CONDITION_DIM), generator=noise)
    runs = {}
    for device, dtype in (("cpu", torch.float32), ("cuda", torch.float32),
                          ("cuda", torch.bfloat16)):
        clip, gen = build_models(cfg, 0, torch.device(device), dtype)
        sample = make_sampler(cfg, clip, gen)
        runs[device, dtype] = [f.float().cpu() for f in sample(
            tok["input_ids"], tok["attention_mask"], z, eps)]
        del clip, gen
    # Bound 1e-3: f32 throughout (TF32 off), sums in other orders through
    # the 12-layer text tower and ~30 conv layers, outputs in [-1, 1].
    bound = 1e-3
    gap = max((a - b).abs().max().item() for a, b in
              zip(runs["cuda", torch.float32], runs["cpu", torch.float32]))
    bf16_gap = max((a - b).abs().max().item() for a, b in
                   zip(runs["cuda", torch.bfloat16],
                       runs["cuda", torch.float32]))
    print(f"sampler {name} f32 card vs CPU, batch 2: max_abs_diff="
          f"{gap:.3e} bound={bound:.0e} {'ok' if gap <= bound else 'FAIL'}")
    print(f"sampler {name} bf16 vs f32 on the card, batch 2: max_abs_diff="
          f"{bf16_gap:.3e}")
    if not gap <= bound:
        raise AssertionError("f32 sampler on the card disagrees with the CPU")


def config(name: str):
    """The packaged config ``name`` (``t2igan_torch.configs``' dict of the
    same YAML: the card machine may lack ``yaml``)."""
    from t2igan_torch import configs
    from t2igan_torch.config import cfg_from_dict

    return cfg_from_dict(getattr(configs, name[:-4].upper()))


def fused_cfg(fused: bool, name: str = "eval_clip_bird.yml"):
    from t2igan_torch.config import cfg_replace

    return cfg_replace(config(name), GAN={"FUSED_TAIL": fused})


def drive_fused_sampler(results, name="eval_clip_bird.yml"):
    """Phase 3b (10a with ``eval_clip_coco.yml``): the sampler with
    GAN.FUSED_TAIL through the generate entry point, then the f32 fused
    sampler against the plain-tail one on the card with the same weights.
    ``results`` (phase 3b's) takes K3's launches of the main path."""
    import torch

    from t2igan_torch.data.tokenizer import ClipTokenizer
    from t2igan_torch.generate import build_models, generate
    from t2igan_torch.ops.kernels import LAUNCHES
    from t2igan_torch.train.steps import make_sampler

    cfg = fused_cfg(True, name)
    batch = cfg.TRAIN.BATCH_SIZE
    captions = [CAPTIONS[i % len(CAPTIONS)] for i in range(2 * batch)]
    calls = -(-len(captions) // batch)
    for kernel in list(LAUNCHES):
        LAUNCHES[kernel] = 0
    t0 = time.perf_counter()
    images = generate(cfg, captions, None, batch, torch.bfloat16, seed=0,
                      device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    if results is not None:
        results["reschain"]["launches"] = counts.get("reschain", 0)
    print(f"fused-tail sampler path: generate, {name} (R_NUM "
          f"{cfg.GAN.R_NUM}), {len(captions)} captions, "
          f"batch {batch}, bf16, GAN.FUSED_TAIL, {calls} sampler calls, "
          f"{seconds:.2f} s with model set-up; launches {counts}")
    if (counts.get("reschain") != 2 * calls
            or counts.get("memory_read_fwd") != 2 * calls
            or counts.get("memory_read_bwd", 0) != 0):
        raise AssertionError(f"expected 2 reschain and 2 memory_read_fwd "
                             f"launches per sampler call, got {counts} in "
                             f"{calls} calls")
    for fakes in images:
        if [tuple(f.shape) for f in fakes] != [(batch, s, s, 3)
                                               for s in (64, 128, 256)]:
            raise AssertionError("fused sampler image shapes")
        if not all(torch.isfinite(f).all() and f.abs().max() <= 1.0
                   for f in fakes):
            raise AssertionError("fused sampler images not finite in [-1, 1]")

    tok = ClipTokenizer.load()(CAPTIONS[:2], max_length=cfg.TEXT.WORDS_NUM)
    noise = torch.Generator().manual_seed(5)
    z = torch.randn((2, cfg.GAN.Z_DIM), generator=noise)
    eps = torch.randn((2, cfg.GAN.CONDITION_DIM), generator=noise)
    runs = {}
    for fused, dtype in ((False, torch.float32), (True, torch.float32),
                         (True, torch.bfloat16)):
        clip, gen = build_models(fused_cfg(fused, name), 0,
                                 torch.device("cuda"), dtype)
        sample = make_sampler(cfg, clip, gen)
        runs[fused, dtype] = [f.float() for f in sample(
            tok["input_ids"], tok["attention_mask"], z, eps)]
        del clip, gen
    # Bound 1e-3 on images in [-1, 1]: the sampler's card-vs-CPU bound;
    # the two f32 tails differ in summation order and BN folding only.
    bound = 1e-3
    gap = max((a - b).abs().max().item() for a, b in
              zip(runs[True, torch.float32], runs[False, torch.float32]))
    bf16_gap = max((a - b).abs().max().item() for a, b in
                   zip(runs[True, torch.bfloat16], runs[True, torch.float32]))
    print(f"fused-tail sampler {name} f32 vs plain-tail sampler f32 on the "
          f"card, batch 2: max_abs_diff={gap:.3e} bound={bound:.0e} "
          f"{'ok' if gap <= bound else 'FAIL'}")
    print(f"fused-tail sampler {name} bf16 vs f32 on the card, batch 2: "
          f"max_abs_diff={bf16_gap:.3e}")
    if not gap <= bound:
        raise AssertionError("fused-tail sampler disagrees with the plain "
                             "tail")


def geneval_models(fused, device, dtype, name="eval_clip_bird.yml"):
    """CLIP, the generator of the config ``name`` (weights from seed 0) and
    the FID Inception-v3 (random weights from seed 7) on ``device`` in
    ``dtype``."""
    import torch

    from t2igan_torch.generate import build_models
    from t2igan_torch.models.inception import InceptionV3, init_inception_

    clip, gen = build_models(fused_cfg(fused, name), 0, torch.device(device),
                             dtype)
    inception = init_inception_(InceptionV3("fid"),
                                torch.Generator().manual_seed(7))
    inception = inception.to(device, dtype,
                             memory_format=torch.channels_last).eval()
    return clip, gen, inception


def drive_geneval():
    """Phase 3c: gen+eval in both tail settings: launch counts, f32 pool3
    on the card vs the CPU at batch 4, and a finite Fréchet distance
    between two generated sets."""
    import torch

    from t2igan_torch.data.tokenizer import ClipTokenizer
    from t2igan_torch.evaluation.fid import (compute_statistics,
                                             frechet_distance,
                                             make_gen_activation_fn)
    from t2igan_torch.ops.kernels import LAUNCHES

    cfg = fused_cfg(False)
    tok = ClipTokenizer.load()([CAPTIONS[i % len(CAPTIONS)]
                                for i in range(4)],
                               max_length=cfg.TEXT.WORDS_NUM)
    noise = torch.Generator().manual_seed(6)
    z = torch.randn((4, cfg.GAN.Z_DIM), generator=noise)
    eps = torch.randn((4, cfg.GAN.CONDITION_DIM), generator=noise)
    for fused in (False, True):
        label = "fused tail" if fused else "plain tail"
        feats, counts = {}, {}
        for device in ("cuda", "cpu"):
            run = make_gen_activation_fn(cfg, *geneval_models(
                fused, device, torch.float32))
            for name in list(LAUNCHES):
                LAUNCHES[name] = 0
            feats[device] = run(tok["input_ids"], tok["attention_mask"], z,
                                eps).float().cpu()
            counts[device] = {k: LAUNCHES[k]
                              for k in ("memory_read_fwd", "reschain")}
            del run
        want = {"cuda": {"memory_read_fwd": 2, "reschain": 2 if fused else 0},
                "cpu": {"memory_read_fwd": 0, "reschain": 0}}
        if counts != want:
            raise AssertionError(f"gen+eval f32 launches {counts}, expected "
                                 f"{want}")
        card, cpu = feats["cuda"], feats["cpu"]
        # Bound: 1e-3 of pool3's largest magnitude, the sampler's image
        # bound carried through a trunk that keeps its scale.
        scale = cpu.abs().max().item()
        gap = (card - cpu).abs().max().item()
        ok = (tuple(card.shape) == (4, 2048) and bool(torch.isfinite(card)
                                                      .all())
              and gap <= 1e-3 * scale)
        print(f"gen+eval {label}, f32 pool3 card vs CPU, batch 4: "
              f"launches on the card {counts['cuda']}; "
              f"max_abs_diff={gap:.3e} bound={1e-3 * scale:.3e} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("gen+eval pool3 on the card disagrees "
                                 "with the CPU")

        # The bf16 path, its launch counts, and FID between two sets.
        run = make_gen_activation_fn(cfg, *geneval_models(
            fused, "cuda", torch.bfloat16))
        b = 16
        tok16 = ClipTokenizer.load()([CAPTIONS[i % len(CAPTIONS)]
                                      for i in range(b)],
                                     max_length=cfg.TEXT.WORDS_NUM)
        ids, mask = tok16["input_ids"], tok16["attention_mask"]
        sets = []
        for seed in (1, 2):
            g = torch.Generator().manual_seed(seed)
            batches = [(ids, mask, torch.randn((b, cfg.GAN.Z_DIM), generator=g),
                        torch.randn((b, cfg.GAN.CONDITION_DIM), generator=g))
                       for _ in range(4)]
            for name in list(LAUNCHES):
                LAUNCHES[name] = 0
            sets.append(compute_statistics(lambda a: run(*a), batches))
            counts = dict(LAUNCHES)
        want = {"memory_read_fwd": 8, "reschain": 8 if fused else 0}
        fid = frechet_distance(*sets[0], *sets[1])
        ok = (all(counts.get(k, 0) == v for k, v in want.items())
              and math.isfinite(fid))
        print(f"gen+eval {label}, bf16, 2 sets of 4 batches of {b}: "
              f"launches per set {counts} (want {want}); FID between the "
              f"sets {fid:.6e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("gen+eval launch counts or FID wrong")


def drive_train_path(results, name="clip_bird_dmgan.yml"):
    """Phase 4a (10a with ``clip_coco_dmgan.yml``): 3 bf16 steps of the
    train_gan trainer at the full width of the config ``name``, the YAML's
    batch of 4, with GAN.FUSED_TAIL set: the fused tail is eval only, so
    no step may launch K3, and each of the step's two G forwards launches
    the four train BN kernels once a BN.  The first step runs eagerly, the
    second captures the step's CUDA graphs and the third replays them, so
    the counters' third step is copied from the capture: a replayed step's
    K1, K2 and BN kernels are also counted by name in its profiler trace
    (:func:`replay_kernels_apart`) and held to the same counts, and
    ``results`` (phase 4a's) takes those."""
    import torch

    from t2igan_torch.ops.kernels import LAUNCHES
    from t2igan_torch.ops.kernels import batchnorm as kbn
    from t2igan_torch.train import graphs
    from t2igan_torch.train.train_gan import CondGanTrainer

    cfg = fused_cfg(True, name)
    t0 = time.perf_counter()
    trainer = CondGanTrainer(cfg, "cuda", torch.bfloat16, seed=0)
    setup = time.perf_counter() - t0
    state = trainer.state
    d = state.ds[-1]

    def snap():
        return {"G": state.gen.ca_net.fc.weight, "EMA": state.gen_ema
                .ca_net.fc.weight, "D": d.trunk.encode.blocks[0].conv.weight,
                "u": d.trunk.encode.blocks[0].conv.u,
                "v": d.trunk.encode.blocks[0].conv.v,
                "head u": d.cond_head.joint.conv.u}

    first = {k: t.detach().clone() for k, t in snap().items()}
    for kernel in list(LAUNCHES):
        LAUNCHES[kernel] = 0
    kbn.BN_LAUNCHES.clear()
    t0 = time.perf_counter()
    per_step = []
    bn_per_step = []
    for _ in range(3):
        before = {k: t.detach().clone() for k, t in snap().items()}
        counts = dict(LAUNCHES)
        bn_counts = dict(kbn.BN_LAUNCHES)
        metrics = trainer.train_steps(1)
        torch.cuda.synchronize()
        per_step.append({k: LAUNCHES[k] - counts.get(k, 0)
                         for k in LAUNCHES})
        bn_per_step.append({k: kbn.BN_LAUNCHES[k] - bn_counts.get(k, 0)
                            for k in kbn.BN_LAUNCHES})
        bad = [k for k, val in metrics.items() if not math.isfinite(val)]
        if bad:
            raise AssertionError(f"non-finite metrics {bad}")
    seconds = time.perf_counter() - t0
    print(f"train path: train_gan, {name} full width (R_NUM "
          f"{cfg.GAN.R_NUM}, LAMBDA {cfg.TRAIN.SMOOTH.LAMBDA}) with "
          f"GAN.FUSED_TAIL, batch "
          f"{cfg.TRAIN.BATCH_SIZE}, bf16, 3 steps in {seconds:.2f} s "
          f"(set-up {setup:.2f} s); counted launches {dict(LAUNCHES)}, per "
          f"step {per_step}; counted BN launches per step {bn_per_step}; "
          f"GAN_GRAPHS {dict(graphs.GAN_GRAPHS)}; last metrics "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(metrics.items())))
    if any(c.get("memory_read_fwd") != 4 or c.get("memory_read_bwd") != 4
           or c.get("reschain", 0) != 0 for c in per_step):
        raise AssertionError("expected 4 memory_read_fwd, 4 memory_read_bwd "
                             "and 0 reschain launches per train step")
    # A G forward: the fc BN, 4 UpBlocks, and per refinement stage R_NUM
    # ResBlocks of 2 BNs and an UpBlock; a step runs two G forwards.
    bns = 2 * (1 + 4 + (cfg.TREE.BRANCH_NUM - 1) * (2 * cfg.GAN.R_NUM + 1))
    want_bn = {k: bns for k in ("stats", "apply", "bwd_reduce", "bwd_dx")}
    if any(c != want_bn for c in bn_per_step):
        raise AssertionError(f"expected {want_bn} BN launches per train "
                             f"step, got {bn_per_step}")
    want_k = {"memory_read_fwd": 4, "memory_read_bwd": 4}
    traced = replay_kernels_apart(name)
    ok = traced == (want_k, want_bn)
    print(f"train path: a replayed step's kernels in its profiler trace "
          f"(a process of its own): K1/K2 {traced[0]}, BN {traced[1]} "
          f"(want {want_k}, {want_bn}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the replayed step ran other K1, K2 or BN "
                             "kernels than its capture recorded")
    if results is not None:
        for kernel in ("memory_read_fwd", "memory_read_bwd"):
            results[kernel]["launches"] = traced[0][kernel]
        results["batchnorm"]["launches"] = traced[1]
    after = {k: t.detach() for k, t in snap().items()}
    moved = {k: (after[k] - first[k]).abs().max().item() for k in first}
    print("train path: max change over 3 steps "
          + ", ".join(f"{k} {v:.3e}" for k, v in moved.items()))
    if not all(moved[k] > 0 for k in ("G", "EMA", "D", "u", "v")):
        raise AssertionError("G, the EMA, D or the spectral vectors did "
                             "not move")
    if moved["head u"] != 0:
        raise AssertionError("the conditional head's u moved")
    want = 0.999 * before["EMA"] + 0.001 * after["G"]
    gap = (after["EMA"] - want).abs().max().item()
    # Same f32 formula on the same card: rounding of three operations.
    bound = 4 * F32_UNIT * want.abs().max().item()
    print(f"train path: EMA vs 0.999 old + 0.001 new (last step) "
          f"max_abs_diff={gap:.3e} bound={bound:.3e} "
          f"{'ok' if gap <= bound else 'FAIL'}")
    if gap > bound:
        raise AssertionError("EMA rule broken")


def check_gan_graphs(card, name="clip_bird_dmgan.yml", dtype_label="bf16",
                     steps=6):
    """Phase 4d: the GAN step as CUDA graphs against its eager body, from
    one state: two ``CondGanTrainer`` of one seed at the full width of
    ``name`` (with ``GAN.FUSED_TAIL``, which only the EMA's samples use)
    and the YAML's batch take ``steps`` steps on the same loader batches
    and noise, A through ``step_fn`` (the graphs), B through
    ``step_fn.eager`` (which ``GAN_GRAPHS`` does not count) with its Adam
    made capturable as the graphs make A's (the same update arithmetic).
    Every step's K1, K2 and BN launches as the wrappers count them (a
    replay's copied from its capture; phase 4a traces a replay's).
    Deterministic algorithms on both, so that cuDNN and cuBLAS choose
    alike; the bound, 1e-6 of a tensor's largest entry, leaves room for
    an algorithm chosen otherwise under capture.  Then a fused-tail sample
    of A's EMA G (sampled once before the steps, so its operands were laid
    out on the weights it started from) against one of a fresh deepcopy of
    it, and the step timed both ways."""
    import copy
    import itertools

    import torch

    from t2igan_torch.ops.kernels import LAUNCHES
    from t2igan_torch.ops.kernels import batchnorm as kbn
    from t2igan_torch.train import graphs
    from t2igan_torch.train.steps import make_sampler
    from t2igan_torch.train.train_gan import DTYPES, CondGanTrainer

    cfg = fused_cfg(True, name)
    dtype = DTYPES[dtype_label]
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.benchmark = False
    a = CondGanTrainer(cfg, "cuda", dtype, seed=0)
    b = CondGanTrainer(cfg, "cuda", dtype, seed=0)
    for opt in (b.state.g_opt, *b.state.d_opts):
        graphs.CudaGraphs.prepare(opt, torch.device("cuda"))
    batches = list(itertools.islice(a.batches(), steps))
    ids, mask = batches[0]["ids"], batches[0]["mask"]
    g = torch.Generator(device="cuda").manual_seed(5)
    z = torch.randn((ids.shape[0], cfg.GAN.Z_DIM), generator=g,
                    device="cuda")
    eps = torch.randn((ids.shape[0], cfg.GAN.CONDITION_DIM), generator=g,
                      device="cuda")

    def sample(gen):
        with torch.no_grad():
            return make_sampler(cfg, a.clip, gen)(ids, mask, z, eps)[-1]

    sample(a.state.gen_ema.eval())  # operands laid out before the steps
    bns = 2 * (1 + 4 + (cfg.TREE.BRANCH_NUM - 1) * (2 * cfg.GAN.R_NUM + 1))
    want_bn = {k: bns for k in ("stats", "apply", "bwd_reduce", "bwd_dx")}
    graphs.GAN_GRAPHS.clear()
    losses = {"graphs": [], "eager": []}
    for i, batch in enumerate(batches):
        for label, trainer, fn in (("graphs", a, a.step_fn),
                                   ("eager", b, b.step_fn.eager)):
            LAUNCHES.clear()
            kbn.BN_LAUNCHES.clear()
            out = fn(trainer.state, batch, generator=trainer.noise)
            losses[label].append({k: float(v) for k, v in out.items()})
            got = dict(LAUNCHES), dict(kbn.BN_LAUNCHES)
            if got != ({"memory_read_fwd": 4, "memory_read_bwd": 4},
                       want_bn):
                raise AssertionError(f"{label} step {i}: launches {got}, "
                                     f"want 4 K1, 4 K2 and {want_bn}")
    counts = dict(graphs.GAN_GRAPHS)
    torch.use_deterministic_algorithms(False)
    # A's first step ran eagerly, its second captured; B's eager body
    # bypasses the counter.
    want = {"eager": 1, "capture": 1, "replay": steps - 1}
    if counts != want:
        raise AssertionError(f"GAN_GRAPHS {counts}, want {want}")
    loss_gap = max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-12)
                   for x, y in zip(losses["graphs"], losses["eager"])
                   for k in y)
    ta, tb = _module_tensors(a), _module_tensors(b)
    if ta.keys() != tb.keys():
        raise AssertionError("the two trainers hold different tensors")
    gaps = {}
    for k in ta:
        x, y = ta[k].double(), tb[k].double()
        gaps[k] = (x - y).abs().max().item() / max(
            y.abs().max().item(), 1e-30)
    worst = sorted(gaps, key=gaps.get, reverse=True)[:3]
    ema = a.state.gen_ema
    fresh = copy.deepcopy(ema)
    x, y = sample(ema), sample(fresh)
    sample_gap = (x.float() - y.float()).abs().max().item()
    ok = loss_gap <= 1e-6 and gaps[worst[0]] <= 1e-6 and sample_gap == 0
    print(f"GAN graphs {name} {dtype_label} batch {cfg.TRAIN.BATCH_SIZE}, "
          f"{steps} steps: GAN_GRAPHS {counts}; 4 K1, 4 K2, {bns} of each "
          f"BN kernel a step (counted); worst loss gap {loss_gap:.3e}, "
          "worst tensor "
          "gaps " + ", ".join(f"{gaps[k]:.3e} ({k})" for k in worst)
          + f"; EMA sample vs a fresh copy {sample_gap:.3e} "
          f"{'ok' if ok else 'FAIL'}")
    print("  losses graphs / eager by step: " + "; ".join(
        f"g {x['g_loss']:.6f}/{y['g_loss']:.6f} d0 {x['d_loss0']:.6f}/"
        f"{y['d_loss0']:.6f}" for x, y in zip(losses["graphs"],
                                              losses["eager"])))
    if not ok:
        raise AssertionError("the GAN step's graphs disagree with its "
                             "eager body")
    # Captured again outside the deterministic algorithms (cuda_ms's
    # warm-up runs the eager step, the capture and a replay).
    a.step_fn.graphs.drop()
    ms = {}
    for label, trainer, fn in (("graphs", a, a.step_fn),
                               ("eager", b, b.step_fn.eager),
                               ("eager ", b, b.step_fn.eager),
                               ("graphs ", a, a.step_fn)):
        it = itertools.cycle(batches)
        ms.setdefault(label.strip(), []).append(cuda_ms(
            lambda: [float(v) for v in fn(trainer.state, next(it),
                                          generator=trainer.noise).values()],
            iters=10))
    print(f"[{card}] GAN step {name} {dtype_label} batch "
          f"{cfg.TRAIN.BATCH_SIZE}, metrics read each step, ms/step in "
          f"turns: graphs {ms['graphs']}, eager {ms['eager']}")
    del a, b
    torch.cuda.empty_cache()
    return ms


def check_train_step_card_vs_cpu():
    """Phase 4a, card vs CPU: one f32 step (TF32 off) on the card against the same step
    on the CPU: same weights, batch and noise, batch 2, full width.  SGD
    (lr 0.01) replaces Adam here, so that the parameter changes compare the
    gradients rather than Adam's first-step sign."""
    import functools

    import torch

    from t2igan_torch.config import cfg_from_dict, cfg_replace
    from t2igan_torch.configs import CLIP_BIRD_DMGAN
    from t2igan_torch.train.state import init_gan_state
    from t2igan_torch.train.train_gan import CondGanTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg_replace(cfg_from_dict(CLIP_BIRD_DMGAN), TRAIN={"BATCH_SIZE": 2})
    noise = torch.Generator().manual_seed(7)
    z = torch.randn((2, cfg.GAN.Z_DIM), generator=noise)
    eps = [torch.randn((2, cfg.GAN.CONDITION_DIM), generator=noise)
           for _ in range(2)]
    sgd = functools.partial(torch.optim.SGD, lr=0.01)
    runs = {}
    for device in ("cpu", "cuda"):
        t0 = time.perf_counter()
        trainer = CondGanTrainer(cfg, device, torch.float32, seed=0)
        state = init_gan_state(cfg, trainer.state.gen, trainer.state.ds,
                               sgd, sgd)
        modules = {"G": state.gen, **{f"D{i}": d
                                      for i, d in enumerate(state.ds)}}

        def tensors():
            return {m: {k: t.detach().cpu().clone()
                        for k, t in mod.state_dict().items()}
                    for m, mod in modules.items()}

        before = tensors()
        metrics = trainer.step_fn(state, next(trainer.batches()), z, *eps)
        runs[device] = ({k: float(v) for k, v in metrics.items()}, before,
                        tensors())
        print(f"train step f32 batch 2 on {device}: "
              f"{time.perf_counter() - t0:.1f} s with set-up")
        del trainer, state, modules
    (m_cpu, before, a_cpu), (m_card, _, a_card) = runs["cpu"], runs["cuda"]
    # Bound: 1e-2 relative.  f32 throughout with TF32 off, but cuDNN picks
    # its own f32 convolution algorithms (Winograd and FFT ones round
    # more than a direct sum) and every sum is reordered, through 12
    # transformer layers, ~40 generator and ~20 discriminator
    # convolutions, forward and backward, and the D update feeding G's
    # loss.  A parameter's change is measured against the largest change
    # in its module (its whole gradient vector), since a tensor whose
    # gradient cancels to a small sum carries the rounding of its terms;
    # running statistics and u/v against their largest entry.
    worst_metric = max(abs(m_card[k] - m_cpu[k]) / max(1.0, abs(m_cpu[k]))
                       for k in m_cpu)
    worst = {}
    for m in a_cpu:
        params = {k for k in a_cpu[m] if k.rsplit(".", 1)[-1] in
                  ("weight", "bias")}
        step = max((a_cpu[m][k] - before[m][k]).abs().max().item()
                   for k in params)
        for k in a_cpu[m]:
            scale = step if k in params else a_cpu[m][k].abs().max().item()
            rel = (a_card[m][k] - a_cpu[m][k]).abs().max().item() / max(
                scale, 1e-12)
            worst[f"{m}.{k}"] = rel
    top = sorted(worst, key=worst.get, reverse=True)[:3]
    ok = worst_metric <= 1e-2 and worst[top[0]] <= 1e-2
    print(f"train step f32 card vs CPU, batch 2: worst metric rel diff "
          f"{worst_metric:.3e}, worst tensor rel diffs "
          + ", ".join(f"{worst[k]:.3e} ({k})" for k in top)
          + f" bound=1e-2 {'ok' if ok else 'FAIL'}")
    print("  metrics card / CPU: " + ", ".join(
        f"{k} {m_card[k]:.6f}/{m_cpu[k]:.6f}" for k in sorted(m_cpu)))
    if not ok:
        raise AssertionError("f32 train step on the card disagrees with "
                             "the CPU")


def scratch_dir() -> str:
    """``output/`` of the checkout (git ignores it), for files a phase
    writes and deletes."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "output")
    os.makedirs(path, exist_ok=True)
    return path


def drive_damsm_path():
    """Phase 4b: the DAMSM trainer at the full width of damsm/bird.yml
    (ViT-B/32, batch 48, 224 px, 30 tokens) in bf16 for 2 epochs of the
    synthetic data (2 steps each), one validation batch an epoch, in a
    temporary directory under the checkout's ``output/``.  It checks
    finite metrics, that both optimizer groups moved and logit_scale did
    not, each group's lr against its one-cycle schedule at every step, no
    K1/K2/K3 launch, clip0.pth and clip1.pth, clip1.pth read into a fresh
    module giving bitwise-equal encodings, and CondGanTrainer holding
    exactly those weights when TRAIN.CLIP_MODEL_CHECKPOINT names the
    file."""
    import tempfile

    import torch

    from t2igan_torch.config import cfg_from_dict, cfg_replace
    from t2igan_torch.configs import CLIP_BIRD_DMGAN, DAMSM_BIRD
    from t2igan_torch.models.convert import load_clip_pth
    from t2igan_torch.models.factory import build_clip
    from t2igan_torch.ops.kernels import LAUNCHES
    from t2igan_torch.train.pretrain_damsm import DamsmTrainer
    from t2igan_torch.train.schedule import cosine_onecycle
    from t2igan_torch.train.train_gan import CondGanTrainer

    cfg = cfg_replace(cfg_from_dict(DAMSM_BIRD),
                      TRAIN={"EVAL_MAX_BATCHES": 1,
                             "CLIP_MODEL_CHECKPOINT": ""})
    with tempfile.TemporaryDirectory(dir=scratch_dir()) as tmp:
        t0 = time.perf_counter()
        trainer = DamsmTrainer(cfg, tmp, "cuda", torch.bfloat16, seed=0)
        setup = time.perf_counter() - t0
        clip, opt = trainer.state.clip, trainer.state.opt
        steps = 2 * len(trainer.train_batches)  # 2 epochs
        total = len(trainer.train_batches) * cfg.TRAIN.MAX_EPOCH
        want = {"backbone": cosine_onecycle(total, cfg.TRAIN.BACKBONE_LR,
                                            0.02, 25.0, 1e4),
                "linear": cosine_onecycle(total, cfg.TRAIN.LINEAR_LR, 0.1,
                                          1e3, 1e6)}
        lrs = []
        step_fn = trainer.step_fn

        def recording_step(batch):
            count = opt.count
            out = step_fn(batch)
            lrs.append((count, {g["name"]: g["lr"]
                                for g in opt.adam.param_groups}))
            return out

        trainer.step_fn = recording_step

        def snap():
            return {"backbone": clip.vision_model.layers[0].fc1.weight,
                    "linear": clip.linear_subr.weight,
                    "logit_scale": clip.logit_scale}

        first = {k: t.detach().clone() for k, t in snap().items()}
        for name in list(LAUNCHES):
            LAUNCHES[name] = 0
        t0 = time.perf_counter()
        metrics = trainer.train(max_epochs=2)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = {k: v for k, v in LAUNCHES.items() if v}
        moved = {k: (t.detach() - first[k]).abs().max().item()
                 for k, t in snap().items()}
        print(f"damsm path: pretrain_damsm trainer, damsm/bird.yml full "
              f"width, batch {cfg.TRAIN.BATCH_SIZE}, bf16, {opt.count} steps "
              f"over 2 epochs with validation and checkpoints in "
              f"{seconds:.2f} s (set-up {setup:.2f} s); kernel launches "
              f"{launched}; last metrics "
              + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items())
              + "; max change " + ", ".join(f"{k} {v:.3e}"
                                            for k, v in moved.items()))
        if not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError("non-finite DAMSM metrics")
        if launched:
            raise AssertionError("the DAMSM path launched a kernel of the "
                                 "GAN path")
        if not (moved["backbone"] > 0 and moved["linear"] > 0) or \
                moved["logit_scale"] != 0:
            raise AssertionError("an optimizer group did not move, or "
                                 "logit_scale did")
        bad = [(c, lr) for c, lr in lrs
               if lr != {k: f(c) for k, f in want.items()}]
        print(f"damsm path: lr per step (count: backbone, linear) "
              + ", ".join(f"{c}: {lr['backbone']:.4e}, {lr['linear']:.4e}"
                          for c, lr in lrs)
              + f"; against the one-cycle schedules over {total} steps "
              f"{'ok' if not bad and len(lrs) == steps else 'FAIL'}")
        if bad or len(lrs) != steps:
            raise AssertionError(f"lr off its schedule: {bad}")

        paths = [trainer.checkpoint_path(e) for e in (0, 1)]
        if not all(os.path.isfile(p) for p in paths):
            raise AssertionError(f"missing checkpoints {paths}")
        figures = sorted(os.listdir(os.path.join(tmp, "Image")))
        rows = metrics_rows(tmp)
        keys = METRICS_KEYS | {"loss", "w_loss", "s_loss", "contrastive",
                               "grad_norm"}
        ok = figures == ["attn_epoch0.png", "attn_epoch1.png"] and \
            [r["step"] for r in rows] == list(range(1, steps + 1)) and \
            all(set(r) == keys for r in rows[1:])
        print(f"damsm path: figures {figures}; metrics.jsonl {len(rows)} "
              f"rows with keys {sorted(keys)} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("DAMSM figures or metrics.jsonl")
        fresh = load_clip_pth(build_clip(), paths[1]).to("cuda")
        batch = next(iter(trainer.val_batches)).arrays(finest_only=True)
        clip.eval()
        with torch.no_grad():
            outs = []
            for m in (clip, fresh):
                outs.append(m.encode_image_verbose(torch.as_tensor(
                    batch["images"], device="cuda"))
                    + m.encode_text_verbose(
                        torch.as_tensor(batch["ids"], device="cuda"),
                        torch.as_tensor(batch["mask"], device="cuda")))
        same = all(torch.equal(a, b) for a, b in zip(*outs))
        gan_cfg = cfg_replace(cfg_from_dict(CLIP_BIRD_DMGAN),
                              TRAIN={"CLIP_MODEL_CHECKPOINT": paths[1]})
        gan = CondGanTrainer(gan_cfg, "cuda", torch.bfloat16, seed=0)
        held = all(torch.equal(a, b) for a, b in
                   zip(clip.state_dict().values(),
                       gan.clip.state_dict().values()))
        size = os.path.getsize(paths[1]) / 2 ** 20
        print(f"damsm path: clip0.pth, clip1.pth ({size:.1f} MiB); clip1.pth "
              f"in a fresh module: encodings bitwise equal {same}; "
              f"CondGanTrainer with CLIP_MODEL_CHECKPOINT holds its weights "
              f"{held}")
        if not (same and held):
            raise AssertionError("clip1.pth does not carry the trained CLIP")
        del trainer, fresh, gan


def _module_tensors(trainer):
    """Every tensor of a GAN trainer's state by name: G, the EMA G and each
    discriminator (parameters, running statistics, spectral vectors), and
    both optimizers' moments."""
    state = trainer.state
    out = {}
    for name, mod in [("G", state.gen), ("EMA", state.gen_ema)] + [
            (f"D{i}", d) for i, d in enumerate(state.ds)]:
        out.update({f"{name}.{k}": v for k, v in mod.state_dict().items()})
    for name, opt in [("g_opt", state.g_opt)] + [
            (f"d_opt{i}", o) for i, o in enumerate(state.d_opts)]:
        for i, st in opt.state_dict()["state"].items():
            out.update({f"{name}.{i}.{k}": v for k, v in st.items()})
    return out


def caption_rows(trainer, n):
    """(ids, mask, class ids) of ``n`` caption rows: the trainer's loader's
    probe batch (no stream moves), its rows repeated."""
    import numpy as np

    batch = trainer.loader.peek(with_images=False)
    idx = np.arange(n) % len(batch.keys)
    return (batch.input_ids[idx], batch.attention_mask[idx],
            batch.class_ids[idx])


def drive_checkpoint_loop(card):
    """Phase 6: train -> checkpoint -> evaluate.  The CondGanTrainer at the
    full width of clip_bird_dmgan.yml trains 2 epochs in bf16 at batch 4
    on the synthetic split with a snapshot after each (full state,
    netG_epoch_%d.pth, netD%d.pth, G_%d.png), with 4 K1, 4 K2 and 0 K3
    launches a step; a fresh trainer resumes bitwise; netG_epoch_1.pth in
    a fresh GNet gives the bitwise f32 sampler output; then the sweep
    (sampling(), eval_clip_bird.yml widths, the YAML's batch of 10, one
    round, both tail settings) from that file, the f32 rank function on
    the card against the CPU at the sweep's batch of 10 with 99
    mis-captions, the fused tail's operand cache after a
    weight load, and the sweep's sampler and rank function timed at
    batch 10 and 128."""
    import tempfile

    import numpy as np
    import torch

    from t2igan_torch.config import cfg_from_dict, cfg_replace
    from t2igan_torch.configs import CLIP_BIRD_DMGAN, EVAL_CLIP_BIRD
    from t2igan_torch.evaluation.rprecision import make_rank_fn
    from t2igan_torch.generate import build_models
    from t2igan_torch.models.convert import load_generator_pth
    from t2igan_torch.models.factory import build_clip, build_generator
    from t2igan_torch.models.clip import init_clip_
    from t2igan_torch.ops.image import resize_nearest
    from t2igan_torch.ops.kernels import LAUNCHES
    from t2igan_torch.train.steps import make_sampler
    from t2igan_torch.train.train_gan import CondGanTrainer

    def reset():
        for name in list(LAUNCHES):
            LAUNCHES[name] = 0

    cfg = cfg_replace(cfg_from_dict(CLIP_BIRD_DMGAN),
                      TRAIN={"MAX_EPOCH": 2, "SNAPSHOT_INTERVAL": 1})
    with tempfile.TemporaryDirectory(dir=scratch_dir()) as out:
        t0 = time.perf_counter()
        trainer = CondGanTrainer(cfg, "cuda", torch.bfloat16, seed=0,
                                 output_dir=out)
        setup = time.perf_counter() - t0
        per_step = []
        step_fn = trainer.step_fn

        per_step_metrics = []

        def counted(*args, **kwargs):
            before = dict(LAUNCHES)
            metrics = step_fn(*args, **kwargs)
            per_step.append({k: LAUNCHES[k] - before.get(k, 0)
                             for k in LAUNCHES})
            per_step_metrics.append(metrics)
            return metrics

        trainer.step_fn = counted
        reset()
        t0 = time.perf_counter()
        metrics = trainer.train(2)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        total = dict(LAUNCHES)
        steps = trainer.state.step
        files = {d: sorted(os.listdir(os.path.join(out, d)))
                 for d in ("Model", "Image")}
        print(f"checkpoint loop: CondGanTrainer.train(2), clip_bird_dmgan.yml "
              f"full width, batch {cfg.TRAIN.BATCH_SIZE}, bf16, "
              f"{len(trainer.dataset)} synthetic records, {steps} steps and "
              f"2 snapshots in {seconds:.2f} s (set-up {setup:.2f} s); "
              f"launches {total}; files {files}; last metrics "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(metrics.items())))
        want_files = {"Model": ["netD0.pth", "netD1.pth", "netD2.pth",
                                "netG_epoch_0.pth", "netG_epoch_1.pth",
                                f"state_{steps // 2:08d}.pt",
                                f"state_{steps:08d}.pt"],
                      "Image": ["G_0.png", "G_0_attn.png", "G_1.png",
                                "G_1_attn.png"]}
        if files != want_files:
            raise AssertionError(f"snapshot files {files}, expected "
                                 f"{want_files}")
        rows = metrics_rows(out)
        keys = METRICS_KEYS | set(per_step_metrics[0])
        ok = [r["step"] for r in rows] == list(range(1, steps + 1)) and \
            all(set(r) == keys for r in rows[1:]) and \
            set(rows[0]) == keys - {"sec_per_step"}
        print(f"checkpoint loop: metrics.jsonl {len(rows)} rows (one a "
              f"step), keys {sorted(keys)}; last row "
              + ", ".join(f"{k} {rows[-1][k]:.4f}" for k in sorted(keys)
                          if k not in ("step", "prefix", "time"))
              + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("metrics.jsonl rows or keys")
        if len(per_step) != steps or any(
                c.get("memory_read_fwd") != 4 or c.get("memory_read_bwd") != 4
                or c.get("reschain", 0) != 0 for c in per_step):
            raise AssertionError("expected 4 memory_read_fwd, 4 "
                                 "memory_read_bwd and 0 reschain launches "
                                 f"per train step, got {per_step}")
        # Each sample sheet is one sampler call that returns the attention
        # maps, so its memory read runs as einsums (no K1), as the JAX
        # trainer's does.
        if total.get("memory_read_fwd") != 4 * steps or \
                total.get("memory_read_bwd") != 4 * steps:
            raise AssertionError(f"launches over the run {total}")
        if not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError("non-finite train metrics")

        # Resume: a fresh trainer restores the newest full state.
        t0 = time.perf_counter()
        resumed = CondGanTrainer(cfg, "cuda", torch.bfloat16, seed=0,
                                 output_dir=out)
        a, b = _module_tensors(trainer), _module_tensors(resumed)
        same = a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                            for k in a)
        same = same and (resumed.epoch, resumed.state.step) == (2, steps) \
            and torch.equal(resumed.noise.get_state(),
                            trainer.noise.get_state()) \
            and resumed.loader.epoch == trainer.loader.epoch \
            and resumed.dataset.rng.bit_generator.state == \
            trainer.dataset.rng.bit_generator.state
        print(f"checkpoint loop: a fresh trainer resumed from "
              f"state_{steps:08d}.pt in {time.perf_counter() - t0:.2f} s: "
              f"{len(a)} tensors (parameters, statistics, spectral vectors, "
              f"Adam moments), step, epoch, the loader's epoch and both "
              f"generators' states bitwise equal {same}")
        if not same:
            raise AssertionError("resumed state differs from the saved run")
        del resumed

        # Reload: netG_epoch_1.pth in a fresh GNet, f32 sampler bitwise.
        net_g = os.path.join(out, "Model", "netG_epoch_1.pth")
        fresh = load_generator_pth(build_generator(cfg), net_g).to(
            "cuda", memory_format=torch.channels_last)
        ids, mask, _ = caption_rows(trainer, 4)
        g = torch.Generator().manual_seed(11)
        z = torch.randn((4, cfg.GAN.Z_DIM), generator=g)
        eps = torch.randn((4, cfg.GAN.CONDITION_DIM), generator=g)
        outs = [make_sampler(cfg, trainer.clip, gen)(ids, mask, z, eps)
                for gen in (trainer.state.gen_ema, fresh)]
        same = all(torch.equal(x, y) for x, y in zip(*outs))
        print(f"checkpoint loop: netG_epoch_1.pth in a fresh GNet, f32 "
              f"sampler at batch 4 bitwise equal to the EMA G's {same}")
        if not same:
            raise AssertionError("netG_epoch_1.pth does not carry the EMA G")
        del trainer, fresh, outs

        sweep_cfg = cfg_replace(cfg_from_dict(EVAL_CLIP_BIRD),
                                TRAIN={"NET_G": net_g})
        b = sweep_cfg.TRAIN.BATCH_SIZE
        for fused in (False, True):
            label = "fused tail" if fused else "plain tail"
            t0 = time.perf_counter()
            ev = CondGanTrainer(cfg_replace(sweep_cfg,
                                            GAN={"FUSED_TAIL": fused}),
                                "cuda", torch.bfloat16, seed=100,
                                output_dir=os.path.join(out, "eval"),
                                split="test")
            setup = time.perf_counter() - t0
            calls = len(ev.dataset) // b
            reset()
            t0 = time.perf_counter()
            mean, std = ev.sampling("valid", num_rounds=1)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = dict(LAUNCHES)
            single = os.path.join(out, "eval", "valid", "single")
            pngs = sum(len(f) for _, _, f in os.walk(single))
            want = {"memory_read_fwd": 2 * calls,
                    "reschain": 2 * calls if fused else 0}
            ok = (all(counts.get(k, 0) == v for k, v in want.items())
                  and counts.get("memory_read_bwd", 0) == 0
                  and pngs == calls * b and 0.0 <= mean <= 1.0)
            print(f"checkpoint loop: sampling() {label}, eval_clip_bird.yml "
                  f"widths from netG_epoch_1.pth, batch {b}, bf16, 1 round "
                  f"of {calls} batches in {seconds:.2f} s (set-up "
                  f"{setup:.2f} s): R mean {mean:.4f} std {std:.4f}, "
                  f"{pngs} PNGs, launches {counts} (want {want}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("sweep launch counts, PNGs or R wrong")

            # The sweep's two parts at batch 10 and 128, CUDA events.
            clip, gen = ev.eval_models()
            sampler, rank = make_sampler(sweep_cfg, clip, gen), \
                make_rank_fn(clip)
            bank = ev.mis_caption_bank(ev.sweep_words(clip))
            for bt in (b, TIMED_BATCH):
                ids, mask, class_ids = caption_rows(ev, bt)
                g = torch.Generator().manual_seed(12)
                z = torch.randn((bt, sweep_cfg.GAN.Z_DIM), generator=g)
                eps = torch.randn((bt, sweep_cfg.GAN.CONDITION_DIM),
                                  generator=g)
                mis = [torch.as_tensor(x, device="cuda")
                       for x in bank.sample(class_ids, 99)]
                ids, mask = (torch.as_tensor(x, device="cuda")
                             for x in (ids, mask))
                z, eps = z.cuda(), eps.cuda()
                images = resize_nearest(sampler(ids, mask, z, eps)[-1],
                                        clip.cfg.image_size).contiguous()
                iters = 10 if bt == b else 3
                s_ms = cuda_ms(lambda: sampler(ids, mask, z, eps), iters)
                torch.cuda.reset_peak_memory_stats()
                r_ms = cuda_ms(lambda: rank(images, ids, mask, *mis), iters)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                print(f"[{card}] sweep {label} bf16 batch {bt}: sampler "
                      f"{s_ms:.3f} ms + rank fn (1 + 99 captions an image, "
                      f"{bt * 100} text rows in one text batch, peak "
                      f"memory {peak:.2f} GiB) {r_ms:.3f} ms = "
                      f"{s_ms + r_ms:.3f} ms/batch")
            del ev, clip, gen, sampler, rank

    # The f32 rank function on the card against the CPU at the sweep's
    # shape: a batch of 10, 99 mis-captions each, 77 tokens a caption
    # (random CLIP from seed 13, TF32 off).  An image's mis-captions are
    # the other captions of CAPTIONS, as the sweep draws other-class ones.
    # Hits must agree wherever the CPU's true-caption score is further
    # from the best mis-caption's than twice the measured difference
    # (there the scores fix the hit), and be the card's argmax == 0
    # everywhere.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clip_cpu = init_clip_(build_clip(), torch.Generator().manual_seed(13))
    clip_card = init_clip_(build_clip(), torch.Generator().manual_seed(13)
                           ).to("cuda")
    from t2igan_torch.data.tokenizer import ClipTokenizer

    tok = ClipTokenizer.load()
    rng = np.random.default_rng(13)
    size, words = clip_cpu.cfg.image_size, min(77,
                                                clip_cpu.cfg.max_positions)
    rb, n_mis = cfg_from_dict(EVAL_CLIP_BIRD).TRAIN.BATCH_SIZE, 99
    images = np.tanh(rng.standard_normal((rb, size, size, 3))).astype(
        np.float32)
    true = tok([CAPTIONS[i % len(CAPTIONS)] for i in range(rb)],
               max_length=words)
    others = (np.arange(rb)[:, None] + rng.integers(
        1, len(CAPTIONS), (rb, n_mis))) % len(CAPTIONS)
    mis = tok([CAPTIONS[i] for i in others.reshape(-1)], max_length=words)
    args = (images, true["input_ids"], true["attention_mask"],
            mis["input_ids"].reshape(rb, n_mis, -1),
            mis["attention_mask"].reshape(rb, n_mis, -1))
    t0 = time.perf_counter()
    h_cpu, s_cpu = make_rank_fn(clip_cpu)(*args)
    cpu_s = time.perf_counter() - t0
    h_card, s_card = make_rank_fn(clip_card)(*args)
    gap = (s_card.cpu() - s_cpu).abs().max().item()
    clear = (s_cpu[:, 0] - s_cpu[:, 1:].amax(dim=1)).abs() > 2 * gap
    hits_ok = torch.equal(h_card.cpu()[clear], h_cpu[clear]) and \
        torch.equal(h_card, s_card.argmax(dim=1) == 0)
    ok = gap <= 1e-4 and hits_ok and s_card.shape == (rb, 1 + n_mis)
    print(f"rank fn f32 card vs CPU, batch {rb} x (1 + {n_mis}) captions of "
          f"{words} tokens (CPU {cpu_s:.2f} s): scores "
          f"max_abs_diff={gap:.3e} bound=1e-4, hits equal on "
          f"{int(clear.sum())}/{rb} clear rows {hits_ok} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("rank fn on the card disagrees with the CPU")
    del clip_cpu, clip_card

    # The fused tail's operand cache: a G that has sampled, then takes new
    # weights through load_state_dict, samples as a freshly built G.
    ev_cfg = fused_cfg(True)
    tok4 = tok(CAPTIONS[:4], max_length=ev_cfg.TEXT.WORDS_NUM)
    g = torch.Generator().manual_seed(14)
    z = torch.randn((4, ev_cfg.GAN.Z_DIM), generator=g)
    eps = torch.randn((4, ev_cfg.GAN.CONDITION_DIM), generator=g)
    clip, old = build_models(ev_cfg, 0, torch.device("cuda"), torch.bfloat16)
    _, newer = build_models(ev_cfg, 1, torch.device("cuda"), torch.bfloat16)
    _, fresh = build_models(ev_cfg, 1, torch.device("cuda"), torch.bfloat16)
    before = make_sampler(ev_cfg, clip, old)(tok4["input_ids"],
                                             tok4["attention_mask"], z, eps)
    old.load_state_dict(newer.state_dict())
    reset()
    after = make_sampler(ev_cfg, clip, old)(tok4["input_ids"],
                                            tok4["attention_mask"], z, eps)
    want = make_sampler(ev_cfg, clip, fresh)(tok4["input_ids"],
                                             tok4["attention_mask"], z, eps)
    same = all(torch.equal(x, y) for x, y in zip(after, want))
    moved = (before[-1].float() - after[-1].float()).abs().max().item()
    print(f"fused-tail operand cache: a G that sampled, then loaded new "
          f"weights, samples bitwise as a fresh G {same} (its output moved "
          f"by {moved:.3e}; launches {dict(LAUNCHES)})")
    if not same or moved == 0 or LAUNCHES["reschain"] != 4:
        raise AssertionError("the fused tail sampled with stale operands")


def check_damsm_step_card_vs_cpu():
    """Phase 4c: one f32 DAMSM step (TF32 off) on the card against the CPU:
    the same weights (seed 0) and batch, batch 4, full width.  The loss
    metrics and every gradient (before the clip) are compared, a gradient
    against its tensor's largest magnitude; then the CPU's gradients go
    into both the card's and the CPU's optimizer, and the updated
    parameters are compared at 1e-6 of each tensor's largest magnitude."""
    import tempfile

    import torch

    from t2igan_torch.config import cfg_from_dict, cfg_replace
    from t2igan_torch.configs import DAMSM_BIRD
    from t2igan_torch.train.pretrain_damsm import DamsmTrainer
    from t2igan_torch.train.steps import make_damsm_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg_replace(cfg_from_dict(DAMSM_BIRD),
                      TRAIN={"BATCH_SIZE": 4, "CLIP_MODEL_CHECKPOINT": ""})
    runs = {}
    with tempfile.TemporaryDirectory(dir=scratch_dir()) as tmp:
        for side, device in (("cpu", "cpu"), ("card", "cuda")):
            t0 = time.perf_counter()
            trainer = DamsmTrainer(cfg, tmp, device, torch.float32, seed=0)
            clip = trainer.state.clip
            batch = next(iter(trainer.train_batches)).arrays(
                finest_only=True)
            total, metrics = make_damsm_loss(cfg, clip)(batch)
            params = dict(clip.named_parameters())
            grads = torch.autograd.grad(total, list(params.values()),
                                        allow_unused=True)
            grads = {n: (torch.zeros_like(p) if g is None else g).cpu()
                     for (n, p), g in zip(params.items(), grads)}
            runs[side] = (trainer, {k: v.item()
                                    for k, v in metrics.items()}, grads)
            print(f"damsm step f32 batch 4 on {device}: "
                  f"{time.perf_counter() - t0:.1f} s with set-up")
    (t_cpu, m_cpu, g_cpu), (t_card, m_card, g_card) = (runs["cpu"],
                                                        runs["card"])
    # Bound 1e-3: f32 with TF32 off, but cuBLAS and the CPU sum in other
    # orders through 24 transformer layers, forward and backward, and the
    # DAMSM scores are sharpened by GAMMA3 = 10 (and gamma2 = 5 in the
    # word terms' log-sum-exp) before their softmaxes.  A gradient is
    # measured against its tensor's largest entry, since an entry that
    # cancels to a small sum carries the rounding of its terms; the qkv
    # biases against their weight's, since the key part's gradient is
    # zero (softmax ignores a shift shared by all keys) and holds only
    # rounding noise.
    def scale(n):
        if n.endswith("qkv_proj.bias"):
            n = n[:-len("bias")] + "weight"
        return max(g_cpu[n].abs().max().item(), 1e-30)

    worst_metric = max(abs(m_card[k] - m_cpu[k]) / max(1.0, abs(m_cpu[k]))
                       for k in m_cpu)
    worst = {n: (g_card[n] - g_cpu[n]).abs().max().item() / scale(n)
             for n in g_cpu}
    top = sorted(worst, key=worst.get, reverse=True)[:3]
    ok = worst_metric <= 1e-3 and worst[top[0]] <= 1e-3
    print(f"damsm step f32 card vs CPU, batch 4: worst metric rel diff "
          f"{worst_metric:.3e}, worst gradient rel diffs "
          + ", ".join(f"{worst[k]:.3e} ({k})" for k in top)
          + f" bound=1e-3 {'ok' if ok else 'FAIL'}")
    print("  metrics card / CPU: " + ", ".join(
        f"{k} {m_card[k]:.6f}/{m_cpu[k]:.6f}" for k in sorted(m_cpu)))
    if not ok:
        raise AssertionError("f32 DAMSM step on the card disagrees with the "
                             "CPU")
    for trainer in (t_cpu, t_card):
        for n, p in trainer.state.clip.named_parameters():
            p.grad = g_cpu[n].to(p.device, copy=True)  # the clip is in place
        trainer.state.opt.step()
    p_cpu = dict(t_cpu.state.clip.named_parameters())
    gap = {n: (p.detach().cpu() - p_cpu[n].detach()).abs().max().item()
           / max(p_cpu[n].abs().max().item(), 1e-30)
           for n, p in t_card.state.clip.named_parameters()}
    top = max(gap, key=gap.get)
    print(f"damsm optimizer card vs CPU on the same gradients: worst "
          f"parameter rel diff {gap[top]:.3e} ({top}) bound=1e-6 "
          f"{'ok' if gap[top] <= 1e-6 else 'FAIL'}")
    if gap[top] > 1e-6:
        raise AssertionError("the DAMSM optimizer on the card disagrees "
                             "with the CPU")


def time_damsm_step(card):
    """Phase 5f: the DAMSM step at batch 48 (damsm/bird.yml: ViT-B/32,
    224 px, 30 tokens) in bf16 and f32 on the JAX bench's DAMSM inputs,
    CUDA events over 10 steps after 3 warm-ups; returns ms/step by
    dtype."""
    import torch

    from t2igan_torch.profile_step import damsm_call

    b = 48
    out = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        step = damsm_call(b, dtype)
        last = {}
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: last.update(step()), iters=10)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        finite = all(math.isfinite(v.item()) for v in last.values())
        print(f"[{card}] damsm step {name} batch {b}: {ms:.3f} ms/step, "
              f"{b * 1000.0 / ms:.1f} images/s, peak memory {peak:.2f} GiB; "
              f"metrics finite {finite}")
        if not finite:
            raise AssertionError("DAMSM step metrics not finite")
        out[name] = ms
        del step
    return out


def time_train_step(card, dtype=None, batch=TRAIN_BATCH):
    """Phase 5b: the train step at batch 16 in bf16 (``dtype`` None), the
    JAX bench's train shape (GF 64, DF 32, R 2, 3 scales, full CLIP, lr
    2e-5, 8 fixture batches); 5g times it in f32 at batch 16 and 4."""
    import torch

    from t2igan_torch.config import cfg_from_dict, cfg_replace
    from t2igan_torch.configs import CLIP_BIRD_DMGAN
    from t2igan_torch.data.synthetic import bench_train_batches
    from t2igan_torch.train.train_gan import CondGanTrainer

    dtype = torch.bfloat16 if dtype is None else dtype
    cfg = cfg_replace(cfg_from_dict(CLIP_BIRD_DMGAN),
                      TRAIN={"BATCH_SIZE": batch,
                             "DISCRIMINATOR_LR": 2e-5,
                             "GENERATOR_LR": 2e-5})
    trainer = CondGanTrainer(cfg, "cuda", dtype, seed=0)
    batches = [{k: ([torch.as_tensor(x, device="cuda") for x in v]
                    if k == "images" else torch.as_tensor(v, device="cuda"))
                for k, v in batch.items()}
               for batch in bench_train_batches(
                   cfg.TRAIN.BATCH_SIZE, trainer.clip.cfg.eos_token_id)]
    it = [0]
    last = {}

    def step():
        last.update(trainer.step_fn(trainer.state, batches[it[0] % 8],
                                    generator=trainer.noise))
        it[0] += 1

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(step, iters=10, warmup=0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finite = all(math.isfinite(float(v)) for v in last.values())
    print(f"[{card}] train step {dtype_name(dtype)} batch {batch}: {ms:.3f} "
          f"ms/step, {1000.0 / ms:.2f} steps/s, {batch * 1000.0 / ms:.1f} "
          f"images/s, peak memory {peak:.2f} GiB; losses after {it[0]} "
          f"steps finite {finite}")
    if not finite:
        raise AssertionError("train step losses not finite")
    return ms


def time_memory_read_bwd(card, results, step_ms, f32_rows):
    """Phase 5d: K2 against memory_read_bwd_plain and the SDPA backward at
    each stage shape of the timed train step, beside the bound; the f32
    route's sums go to ``f32_rows`` (its bound by :func:`f32_bound`, SDPA
    in f32 with TF32 off).  ``step_ms``: the bf16 step's time, or None."""
    import torch
    import torch.nn.functional as F

    from t2igan_torch.ops.kernels.memory_read import (memory_read_bwd,
                                                      memory_read_bwd_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for hw in STAGE_HW:
            b = TRAIN_BATCH
            q, k, v, pad = memory_read_inputs(b, hw, dtype, "ragged", 13)
            pad[-1] = False  # SDPA gives NaN on a fully masked row
            dout = torch.randn(q.shape, device="cuda").to(dtype)
            n = hw[0] * hw[1]
            e = q.element_size()
            nbytes = (3 * b * n * CHANNELS + 4 * b * SLOTS * CHANNELS) * e \
                + b * SLOTS
            flops = 10 * b * n * SLOTS * CHANNELS
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[name] * 1e3
            bound = max(t_bytes, t_ops)
            bound_text = (f"bound {bound:.4f} ms (bytes {nbytes / 1e6:.1f} MB"
                          f" -> {t_bytes:.4f} ms, {flops / 1e9:.2f} GFLOP "
                          f"-> {t_ops:.4f} ms)")
            if name == "f32":
                bound, t_bytes, t_ops, _ = f32_bound(nbytes, flops)
                bound_text = f32_bound_text(nbytes, flops)
            keep = (~pad)[:, None, None, :]
            q4 = q.view(b, 1, n, CHANNELS).detach().requires_grad_()
            k4 = k[:, None].detach().requires_grad_()
            v4 = v[:, None].detach().requires_grad_()
            d4 = dout.view(b, 1, n, CHANNELS)

            def sdpa():
                return F.scaled_dot_product_attention(q4, k4, v4,
                                                      attn_mask=keep,
                                                      scale=1.0)

            ms, host = queued_ms(lambda: memory_read_bwd(q, k, v, pad, dout),
                                 iters=20)
            plain, _ = queued_ms(lambda: memory_read_bwd_plain(q, k, v, pad,
                                                               dout), iters=5)
            fwd, _ = queued_ms(sdpa, iters=20)
            both, _ = queued_ms(lambda: torch.autograd.grad(
                sdpa(), (q4, k4, v4), d4), iters=20)
            lib = both - fwd
            print(f"[{card}] memory_read_bwd {name} B={b} HW={hw[0]}x{hw[1]} "
                  f"C={CHANNELS} L={SLOTS}: kernel {ms:.4f} ms "
                  f"({nbytes / ms / 1e6:.0f} GB/s; host {host:.1f} us a "
                  f"wrapper call), plain "
                  f"{plain:.4f} ms, sdpa backward {lib:.4f} ms (fwd+bwd "
                  f"{both:.4f} - fwd {fwd:.4f}), {bound_text}, "
                  f"{bound / ms:.1%} of bound")
            by = "bytes" if t_bytes >= t_ops else "operations"
            if name == "bf16":
                for key, val in (("ms", ms), ("plain_ms", plain),
                                 ("bound_ms", bound), ("library_ms", lib)):
                    totals[key] += val
                results["memory_read_bwd"]["bound_by"] = by
            else:
                add_row(f32_rows, f"memory_read_bwd f32 B={b}", ms=ms,
                        plain_ms=plain, bound_ms=bound, library_ms=lib,
                        bound_by=by)
    results["memory_read_bwd"].update(totals)
    if step_ms is None:
        return
    # Two caption views per step, each one launch per stage shape.
    share = 2 * totals["ms"] / step_ms
    print(f"[{card}] K2 in the bf16 batch-{TRAIN_BATCH} train step: 4 "
          f"launches, {2 * totals['ms']:.3f} ms of {step_ms:.3f} ms/step "
          f"({share:.1%}), timed apart")


def bench_inputs(cfg, b, eos_token_id):
    """The JAX bench's gen inputs at batch ``b``: ids all <eos>, full mask,
    z and eps from seed 3."""
    import torch

    w = cfg.TEXT.WORDS_NUM
    ids = torch.full((b, w), eos_token_id, dtype=torch.int32, device="cuda")
    mask = torch.ones((b, w), dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    z = torch.randn((b, cfg.GAN.Z_DIM), generator=g, device="cuda")
    eps = torch.randn((b, cfg.GAN.CONDITION_DIM), generator=g, device="cuda")
    return ids, mask, z, eps


def time_sampler(card, config_name="eval_clip_bird.yml", geneval=True,
                 dtype=None, b=TIMED_BATCH):
    """Phase 5a (10a with ``eval_clip_coco.yml`` and no gen+eval): the
    sampler, then gen+eval, at batch 128 in bf16 (``dtype`` None), the JAX
    bench's gen shape and inputs, with the plain and the fused tail; 5g
    times the sampler in f32 at batch 128 and 10.  Returns the ms of each
    timed call by its label."""
    import torch

    from t2igan_torch.evaluation.fid import make_gen_activation_fn
    from t2igan_torch.train.steps import make_sampler

    dtype = torch.bfloat16 if dtype is None else dtype
    out = {}
    for fused in (False, True):
        cfg = fused_cfg(fused, config_name)
        clip, gen, inception = geneval_models(fused, "cuda", dtype,
                                              config_name)
        args = bench_inputs(cfg, b, clip.cfg.eos_token_id)
        label = "fused tail" if fused else "plain tail"
        if config_name != "eval_clip_bird.yml":
            label += f", {config_name} (R_NUM {cfg.GAN.R_NUM})"
        paths = [("sampler", make_sampler(cfg, clip, gen))]
        if geneval:
            paths.append(("gen+eval", make_gen_activation_fn(
                cfg, clip, gen, inception)))
        for name, fn in paths:
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: fn(*args), iters=10)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            print(f"[{card}] {name} {label} {dtype_name(dtype)} batch {b}: "
                  f"{ms:.3f} ms/batch, {b * 1000.0 / ms:.1f} images/s, peak "
                  f"memory {peak:.2f} GiB")
            out[f"{name} {label}"] = ms
        del clip, gen, inception
    return out


def time_reschain(card, results, n_res=2, dtype=None):
    """Phase 5e: K3 at each stage shape of the timed sampler (batch 128,
    bf16, ``n_res`` ResBlocks) against resblock_chain_up_plain and, for
    context, the port's eval module chain for the same tail, beside its
    bound, and each launch kind's time (profiler) beside its bound and
    cuDNN's.  K3 runs as the sampler runs it: on operands laid out once
    (``lay_out_operands``; ``NextStageG`` keeps them), through
    ``fused_tail``.  With ``results`` None (10a, R = 3; 5g in f32, TF32
    off, bound by :func:`f32_bound`) the times are printed only, and the
    launch kinds only in f32 (after phase 9 the profiler traces no
    kernel in this process); returns the two stages' kernel, plain, chain
    and bound ms."""
    import torch

    from t2igan_torch.ops.kernels.reschain import (fused_tail,
                                                   lay_out_operands,
                                                   resblock_chain_up_plain)
    from t2igan_torch.profile_step import kernel_ms_by_family

    dtype = torch.bfloat16 if dtype is None else dtype
    name = dtype_name(dtype)
    e = 2 if dtype == torch.bfloat16 else 4  # bytes an element
    b, c = TIMED_BATCH, TAIL_CHANNELS
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    chain_total = 0.0
    for hw, rgb in ((STAGE_HW[0], False), (STAGE_HW[1], True)):
        mods, chain = tail_modules(c, n_res, rgb, dtype, 11)
        x, _, _, _ = reschain_inputs(b, hw, c, n_res, False, dtype, 11)
        rb = [m.fold() for m in mods[:n_res]]
        up = mods[n_res].fold()
        head = mods[-1].fold() if rgb else None
        x_nchw = x.permute(0, 3, 1, 2)
        n = hw[0] * hw[1]
        flops = 2 * b * n * (n_res * 9 * (2 * c * c + c * c) + 16 * c * c)
        nbytes = e * (b * n * c + n_res * 9 * 3 * c * c + 9 * c * c) \
            + 4 * (n_res * 6 * c + 2 * c)
        if rgb:
            flops += 2 * b * 4 * n * 9 * (c // 2) * 3
            nbytes += e * (9 * (c // 2) * 3 + b * 4 * n * 3)
        else:
            nbytes += e * b * 4 * n * (c // 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["bf16"] * 1e3
        bound = max(t_bytes, t_ops)
        bound_text = (f"bound {bound:.4f} ms (bytes {nbytes / 1e6:.1f} MB -> "
                      f"{t_bytes:.4f} ms, {flops / 1e12:.3f} TFLOP -> "
                      f"{t_ops:.4f} ms)")
        if dtype == torch.float32:
            bound, t_bytes, t_ops, _ = f32_bound(nbytes, flops)
            bound_text = f32_bound_text(nbytes, flops)
        with torch.inference_mode():
            ops = lay_out_operands(rb, *up, head, dtype)
            ms, host = queued_ms(lambda: fused_tail(x, ops, not rgb), iters=10)
            plain, _ = queued_ms(lambda: resblock_chain_up_plain(
                x, rb, *up, head, not rgb), iters=5)
            mod_ms, _ = queued_ms(lambda: chain(x_nchw), iters=10)
            by_kind = (kernel_ms_by_family(lambda: fused_tail(x, ops, not rgb))
                       if results is not None or dtype == torch.float32
                       else None)
        print(f"[{card}] reschain {name} B={b} HW={hw[0]}x{hw[1]} C={c} "
              f"R={n_res} {'RGB head only' if rgb else 'features'}: kernel "
              f"{ms:.4f} ms (host {host:.1f} us a call), plain {plain:.4f} ms, "
              f"eval module chain {mod_ms:.4f} ms, {bound_text}, "
              f"{bound / ms:.1%} of bound, {flops / ms / 1e9:.1f} TFLOP/s")
        for key, val in (("ms", ms), ("plain_ms", plain), ("bound_ms", bound)):
            totals[key] += val
        chain_total += mod_ms
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        del mods, chain, ops
        if by_kind is not None:
            time_cudnn_convs(card, x_nchw, rgb, n_res, by_kind)
        del x, x_nchw
    if results is not None:
        results["reschain"].update(totals, bound_by=bound_by)
        # No single PyTorch call computes the fused tail.
        results["reschain"]["library_ms"] = None
    print(f"[{card}] reschain {name} R={n_res}, both stages: kernel "
          f"{totals['ms']:.3f} ms, plain {totals['plain_ms']:.3f} ms, eval "
          f"module chain {chain_total:.3f} ms, bound "
          f"{totals['bound_ms']:.3f} ms ({bound_by}), "
          f"{totals['bound_ms'] / totals['ms']:.1%} of bound")
    return dict(totals, chain_ms=chain_total, bound_by=bound_by)


def time_f32_paths(card, f32_rows):
    """Phase 5g: the f32 routes of the kernels and the paths that launch
    them, f32 being every entry point's default ``--dtype``: K3 f32 at the
    sampler's batch-128 stage shapes with R = 2 and COCO's R = 3 beside
    the f32 eval module chain (TF32 off); the f32 train step (4 K1 + 4 K2
    launches) at batch 16 and at clip_bird_dmgan.yml's 4; the f32 sampler
    (2 K1, plus 2 K3 with the fused tail) at batch 128 and at
    eval_clip_bird.yml's 10.  Adds the rows to ``f32_rows``."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for n_res in (2, 3):
        t = time_reschain(card, None, n_res, torch.float32)
        add_row(f32_rows, f"reschain f32 B={TIMED_BATCH} R={n_res}",
                ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                library_ms=t["chain_ms"], bound_by=t["bound_by"])
    for batch in (TRAIN_BATCH, 4):
        f32_rows[f"train step f32 batch {batch}"] = {
            "ms": time_train_step(card, torch.float32, batch)}
    for batch in (TIMED_BATCH, 10):
        for label, ms in time_sampler(card, geneval=False,
                                      dtype=torch.float32, b=batch).items():
            f32_rows[f"{label} f32 batch {batch}"] = {"ms": ms}


def time_f32(card):
    """Phase 5's f32 rows alone (K1, K2 and K3 in f32 with their bf16
    neighbours, then the f32 paths), for an A/B against another tree: run
    from that tree's root with this file copied there, e.g.
    ``python3 -c 'import chip_smoke_ab as c; c.time_f32(c.card_line())'``.
    Prints the rows as one JSON line."""
    from t2igan_torch.ops.kernels import build

    build.build(build.SOURCES)
    stub = {name: {} for name in ("memory_read_fwd", "memory_read_bwd")}
    rows = {}
    time_memory_read(card, stub, rows)
    time_memory_read_bwd(card, stub, None, rows)
    time_f32_paths(card, rows)
    print(json.dumps({"f32_rows": rows, "card": card}))


K3_KINDS = {"C->2C + GLU": "K3 conv C->2C + GLU",
            "C->C + residual": "K3 conv C->C + residual",
            "upsample phases + GLU": "K3 upsample phases + GLU",
            "RGB head": "K3 RGB head"}


def time_cudnn_convs(card, x_nchw, rgb, n_res, by_kind):
    """Each launch kind of K3 at one stage shape: its device time in the
    fused tail (``by_kind``, from ``profile_step.kernel_ms_by_family``; the
    C -> 2C and C -> C kinds launch ``n_res`` times a call) against the
    work of one launch and its bound at the card's peak (f32: its work as
    3xTF32, or its bytes), beside cuDNN (``F.conv2d``, channels-last, in
    x's dtype) for the same conv as the module chain runs it, the yardstick
    of that kind; in f32 with TF32 off (the yardstick) and, for context,
    on.  The kinds: C -> 2C and C -> C 3x3 on x, C -> C over the nearest-2x
    map (K3's four subpixel phases do 4/9 of its flops), the head C/2 -> 3
    on the 2x map (bound by the bytes it reads).  The port never calls
    cuDNN here."""
    import torch
    import torch.nn.functional as F

    b, c, h, w = x_nchw.shape
    n = h * w
    dtype = x_nchw.dtype
    f32 = dtype == torch.float32
    e = 4 if f32 else 2
    g = torch.Generator(device="cuda").manual_seed(12)

    def weight(cout, cin):
        return (torch.randn((cout, cin, 3, 3), generator=g, device="cuda")
                * (9 * cin) ** -0.5).to(dtype).contiguous(
                    memory_format=torch.channels_last)

    def ops_ms(flops):
        if f32:
            return f32_bound(0, flops)[0]
        return flops / PEAK_FLOPS["bf16"] * 1e3

    x2 = F.interpolate(x_nchw, scale_factor=2, mode="nearest").contiguous(
        memory_format=torch.channels_last)
    # (kind, launches a call, K3's flops a launch, its bound ms, cuDNN
    # input, weight)
    kinds = [("C->2C + GLU", n_res, 2 * b * n * 9 * c * 2 * c, x_nchw,
              weight(2 * c, c)),
             ("C->C + residual", n_res, 2 * b * n * 9 * c * c, x_nchw,
              weight(c, c)),
             ("upsample phases + GLU", 1, 2 * b * n * 16 * c * c, x2,
              weight(c, c))]
    kinds = [(k, m, f, ops_ms(f), i, wt) for k, m, f, i, wt in kinds]
    if rgb:
        up = x2[:, :c // 2].contiguous(memory_format=torch.channels_last)
        head_bytes = e * (b * 4 * n * (c // 2) + b * 4 * n * 3)
        flops = 2 * b * 4 * n * 9 * (c // 2) * 3
        kinds.append(("RGB head", 1, flops,
                      max(head_bytes / HBM_BYTES_PER_S * 1e3, ops_ms(flops)),
                      up, weight(3, c // 2)))
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        with torch.inference_mode():
            for name, launches, flops, bound, inp, wt in kinds:
                k3 = by_kind.get(K3_KINDS[name], 0.0) / launches
                times = []
                for allow in ((False, True) if f32 else (tf32,)):
                    torch.backends.cudnn.allow_tf32 = allow
                    ms, _ = queued_ms(lambda: F.conv2d(inp, wt, padding=1),
                                      iters=10)
                    times.append(ms)
                cudnn = (f"cuDNN F.conv2d f32 channels-last TF32 off "
                         f"(yardstick, not in the port) {times[0]:.4f} ms, "
                         f"TF32 on (context) {times[1]:.4f} ms" if f32 else
                         f"cuDNN F.conv2d bf16 channels-last (yardstick, not "
                         f"in the port) {times[0]:.4f} ms")
                print(f"[{card}] K3 kind {name} {dtype_name(dtype)}, B={b} "
                      f"HW={h}x{w} C={c}: K3 {k3:.4f} ms a launch (x"
                      f"{launches}), {flops / 1e9:.1f} GFLOP a launch, bound "
                      f"{bound:.4f} ms, {bound / k3 if k3 else 0.0:.1%} of "
                      f"bound; {cudnn}")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def time_memory_read(card, results, f32_rows):
    """Phase 5c: K1 against memory_read_plain and SDPA at each stage shape
    of the timed sampler, beside the bound; the f32 route's sums go to
    ``f32_rows`` (its bound by :func:`f32_bound`, SDPA in f32 with TF32
    off)."""
    import torch
    import torch.nn.functional as F

    from t2igan_torch.ops.kernels.memory_read import (memory_read_fused,
                                                      memory_read_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for hw in STAGE_HW:
            b = TIMED_BATCH
            q, k, v, pad = memory_read_inputs(b, hw, dtype, "ragged", 11)
            pad[-1] = False  # SDPA gives NaN on a fully masked row
            n = hw[0] * hw[1]
            e = q.element_size()
            nbytes = 2 * b * n * CHANNELS * e + 2 * b * SLOTS * CHANNELS * e \
                + b * SLOTS
            flops = 4 * b * n * SLOTS * CHANNELS
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[name] * 1e3
            bound = max(t_bytes, t_ops)
            bound_text = (f"bound {bound:.4f} ms (bytes {nbytes / 1e6:.1f} MB"
                          f" -> {t_bytes:.4f} ms, {flops / 1e9:.2f} GFLOP "
                          f"-> {t_ops:.4f} ms)")
            if name == "f32":
                bound, t_bytes, t_ops, _ = f32_bound(nbytes, flops)
                bound_text = f32_bound_text(nbytes, flops)
            keep = (~pad)[:, None, None, :]
            q4, k4, v4 = q.view(b, 1, n, CHANNELS), k[:, None], v[:, None]
            ms, host = queued_ms(lambda: memory_read_fused(q, k, v, pad),
                                 iters=20)
            plain, _ = queued_ms(lambda: memory_read_plain(q, k, v, pad),
                                 iters=5)
            lib, _ = queued_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=keep, scale=1.0), iters=20)
            print(f"[{card}] memory_read_fwd {name} B={b} HW={hw[0]}x{hw[1]} "
                  f"C={CHANNELS} L={SLOTS}: kernel {ms:.4f} ms "
                  f"({nbytes / ms / 1e6:.0f} GB/s; host {host:.1f} us a "
                  f"wrapper call), plain "
                  f"{plain:.4f} ms, sdpa {lib:.4f} ms, {bound_text}, "
                  f"{bound / ms:.1%} of bound")
            by = "bytes" if t_bytes >= t_ops else "operations"
            if name == "bf16":
                for key, val in (("ms", ms), ("plain_ms", plain),
                                 ("bound_ms", bound), ("library_ms", lib)):
                    totals[key] += val
                results["memory_read_fwd"]["bound_by"] = by
            else:
                add_row(f32_rows, f"memory_read_fwd f32 B={b}", ms=ms,
                        plain_ms=plain, bound_ms=bound, library_ms=lib,
                        bound_by=by)
    results["memory_read_fwd"].update(totals)

# ------------------------------------------------------------- phase 7 ----

def check_decoder():
    """Phase 7a: every committed image fixture decoded by the port's own
    decoder, held to the sha256 of PIL's RGB bytes recorded beside it."""
    import hashlib

    from t2igan_torch.data import native

    testdata = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "t2igan_torch", "testdata")
    with open(os.path.join(testdata, "fixtures.json")) as f:
        record = json.load(f)
    seconds = native.build()
    print(f"real data: host library built with g++ in {seconds:.1f} s "
          f"({native.library_path().name})")
    bad = []
    t0 = time.perf_counter()
    for name, rec in sorted(record["files"].items()):
        rgb = native.decode_image(os.path.join(testdata, name))
        if hashlib.sha256(rgb.tobytes()).hexdigest() != rec["sha256_rgb"] \
                or list(rgb.shape) != rec["shape"]:
            bad.append(name)
    seconds = time.perf_counter() - t0
    n = len(record["files"])
    print(f"real data: decoded {n} fixtures ({record['written_by']}) in "
          f"{seconds:.3f} s: {n - len(bad)} match PIL's RGB sha256"
          f"{' ok' if not bad else ', FAIL ' + str(bad)}")
    if bad or n < 30:
        raise AssertionError(f"decoded fixtures differ from PIL's: {bad}")
    return cub_sources()


def time_loader_parts(card, sources, tree, words, sizes, batch):
    """Where a loader's time goes, on one host thread: decode, bbox crop +
    scale/crop/flip + pyramid + normalise, collate (tokenise both views),
    and the pinned host-to-device copy of a batch (CUDA events)."""
    import numpy as np
    import torch

    from t2igan_torch.data import native
    from t2igan_torch.data.dataset import ImageTransform, crop_to_bbox
    from t2igan_torch.data.tokenizer import ClipTokenizer

    reps = 3
    t0 = time.perf_counter()
    imgs = [native.decode_image(s) for _ in range(reps) for s in sources]
    decode = (time.perf_counter() - t0) / len(imgs) * 1e3
    tf = ImageTransform(sizes[-1])
    crops = [crop_to_bbox(im, (im.shape[1] // 8, im.shape[0] // 8,
                               im.shape[1] * 3 // 4, im.shape[0] * 3 // 4))
             for im in imgs]
    t0 = time.perf_counter()
    for im in crops:
        nw, nh = tf.scaled_dims(im.shape[1], im.shape[0])
        native.pyramid(im, tf.scale, tf.imsize, (nw - tf.imsize) // 2,
                       (nh - tf.imsize) // 2, True, sizes)
    pyramid = (time.perf_counter() - t0) / len(crops) * 1e3
    tok = ClipTokenizer.load(None)
    with open(os.path.join(tree, "captions.pickle"), "rb") as f:
        caps = pickle.load(f)[0]
    t0 = time.perf_counter()
    for i in range(5):
        tok(caps[i * batch:(i + 1) * batch], max_length=words)
        tok(caps[(i + 1) * batch:(i + 2) * batch], max_length=words)
    tokenise = (time.perf_counter() - t0) / 5 * 1e3
    host = [torch.empty((batch, s, s, 3), pin_memory=True) for s in sizes]
    ms = cuda_ms(lambda: [h.to("cuda", non_blocking=True) for h in host],
                 iters=10)
    mb = sum(h.numel() * 4 for h in host) / 2 ** 20
    print(f"[{card}] loader parts, one host thread, batch {batch} at "
          f"{'/'.join(map(str, sizes))} px: decode {decode:.3f} ms an image "
          f"(CUB-sized fixtures), bbox crop + scale/crop/flip + pyramid + "
          f"normalise {pyramid:.3f} ms an image, tokenise both views "
          f"{tokenise:.3f} ms a batch, pinned H2D copy of {mb:.1f} MiB "
          f"{ms:.3f} ms a batch")
    return decode + pyramid


def time_loader(card, cfg, words, workers, epochs):
    """Phase 7c: the loader alone on the tree (native engine, images in
    pinned memory, no step behind it): images/s and ms a batch over
    ``epochs`` epochs after one warm-up epoch."""
    from t2igan_torch.data.dataset import TextImageDataset
    from t2igan_torch.data.pipeline import DataLoader
    from t2igan_torch.data.tokenizer import ClipTokenizer

    ds = TextImageDataset(cfg, "train")
    loader = DataLoader(ds, ClipTokenizer.load(None), cfg.TRAIN.BATCH_SIZE,
                        words, num_workers=workers, pin_memory=True)
    try:
        list(loader)
        t0 = time.perf_counter()
        n = 0
        for _ in range(epochs):
            for batch in loader:
                n += len(batch.keys)
        seconds = time.perf_counter() - t0
    finally:
        loader.close()
    batches = n // cfg.TRAIN.BATCH_SIZE
    print(f"[{card}] loader {'/'.join(map(str, cfg.branch_sizes))} px, "
          f"batch {cfg.TRAIN.BATCH_SIZE}, {workers} workers "
          f"({loader.engine_in_use()} engine): {n / seconds:.1f} images/s, "
          f"{seconds / batches * 1e3:.3f} ms a batch ({n} images)")
    return n / seconds


def drive_real_data(card, train_ms, damsm_ms):
    """Phase 7: real data on the card.  (a) the committed fixtures decoded
    bitwise as PIL; (b) a CUB-shaped tree of the CUB-sized fixtures (96
    train and 32 test records over 8 classes, seeded bboxes, 10 captions
    an image); (c) the loader alone at clip_bird_dmgan.yml's pyramid
    (batch 16, WORKERS 2 and 8) and damsm/bird.yml's 224 px (batch 48,
    WORKERS 1 and 8); (d) CondGanTrainer on the tree at full width, bf16,
    batch 16, the epoch loop of its train() (one warm epoch, two timed;
    4 K1 + 4 K2 a step) at WORKERS 2 and 8, beside the synthetic step of
    phase 5b; (e) DamsmTrainer on the tree, bf16, batch 48, one warm epoch
    and two timed at WORKERS 1 and 8, beside phase 5f's synthetic step; (f)
    sampling() one round at eval_clip_bird.yml widths writing PNGs, then
    ``python -m t2igan_torch.fid_score`` (PNGs against the tree's images)
    and ``python -m t2igan_torch.inception_score``, random Inception
    weights."""
    import tempfile

    import torch

    from t2igan_torch.config import cfg_from_dict, cfg_replace
    from t2igan_torch.configs import CLIP_BIRD_DMGAN, DAMSM_BIRD, \
        EVAL_CLIP_BIRD
    from t2igan_torch.data.cub_tree import write_cub_tree
    from t2igan_torch.data.dataset import TextImageDataset
    from t2igan_torch.ops.kernels import LAUNCHES
    from t2igan_torch.train.pretrain_damsm import DAMSM_WORDS_NUM, \
        DamsmTrainer
    from t2igan_torch.train.train_gan import CondGanTrainer

    def reset():
        for name in list(LAUNCHES):
            LAUNCHES[name] = 0

    sources = check_decoder()
    with tempfile.TemporaryDirectory(dir=scratch_dir()) as tmp:
        t0 = time.perf_counter()
        tree = write_cub_tree(tmp, sources, n_train=96, n_test=32,
                              n_classes=8, captions_per_image=10, seed=0)
        print(f"real data: CUB-shaped tree of {len(sources)} CUB-sized "
              f"JPEGs, 96 train + 32 test records over 8 classes, written "
              f"in {time.perf_counter() - t0:.2f} s")
        gan_cfg = cfg_replace(cfg_from_dict(CLIP_BIRD_DMGAN), DATA_DIR=tree,
                              TRAIN={"BATCH_SIZE": TRAIN_BATCH,
                                     "CLIP_MODEL_CHECKPOINT": ""})
        damsm_cfg = cfg_replace(cfg_from_dict(DAMSM_BIRD), DATA_DIR=tree,
                                TRAIN={"EVAL_MAX_BATCHES": 1})
        for cfg, words in ((gan_cfg, gan_cfg.TEXT.WORDS_NUM),
                           (damsm_cfg, DAMSM_WORDS_NUM)):
            time_loader_parts(card, sources, tree, words, cfg.branch_sizes,
                              cfg.TRAIN.BATCH_SIZE)
            for workers in (cfg.WORKERS, 8):
                time_loader(card, cfg, words, workers,
                            epochs=4 if cfg is gan_cfg else 6)

        # (d) the GAN trainer on decoded data.
        trainer = CondGanTrainer(gan_cfg, "cuda", torch.bfloat16, seed=0)
        if not isinstance(trainer.dataset, TextImageDataset):
            raise AssertionError("the GAN trainer did not read the tree")
        per_step = []
        step_fn = trainer.step_fn

        def counted(*args, **kwargs):
            before = dict(LAUNCHES)
            out = step_fn(*args, **kwargs)
            per_step.append({k: LAUNCHES[k] - before.get(k, 0)
                             for k in LAUNCHES})
            return out

        trainer.step_fn = counted

        def epochs(n):
            """``n`` epochs of the loop of CondGanTrainer.train (no
            snapshot, no sync inside); returns the last step's output."""
            out = {}
            for _ in range(n):
                order = trainer.loader.next_order()
                for batch in trainer.device_batches(
                        trainer.loader.batches(order)):
                    out = trainer.step_fn(trainer.state, batch,
                                          generator=trainer.noise)
            return out

        for workers in (gan_cfg.WORKERS, 8):
            trainer.loader.close()
            trainer.loader.num_workers = workers
            epochs(1)
            torch.cuda.synchronize()
            reset()
            per_step.clear()
            t0 = time.perf_counter()
            metrics = {k: float(v) for k, v in epochs(2).items()}
            torch.cuda.synchronize()
            steps = len(per_step)
            ms = (time.perf_counter() - t0) / steps * 1e3
            ok = (steps == 2 * len(trainer.loader) and all(
                c.get("memory_read_fwd") == 4
                and c.get("memory_read_bwd") == 4
                and c.get("reschain", 0) == 0 for c in per_step)
                and all(math.isfinite(v) for v in metrics.values()))
            print(f"[{card}] real-data GAN train bf16 batch {TRAIN_BATCH} "
                  f"(clip_bird_dmgan.yml widths, {workers} workers"
                  f"{' = WORKERS' if workers == gan_cfg.WORKERS else ''}, "
                  f"decoded tree; the epoch loop of CondGanTrainer.train, "
                  f"loader and H2D included): {ms:.3f} ms/step over {steps} "
                  f"steps (2 epochs), against {train_ms:.3f} ms/step on "
                  f"device-resident synthetic batches (phase 5b, same "
                  f"call); launches {dict(LAUNCHES)} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"real-data train steps: {per_step}, "
                                     f"{metrics}")
        trainer.loader.close()
        del trainer

        # (e) DAMSM on decoded data.
        out = os.path.join(tmp, "damsm")
        trainer = DamsmTrainer(damsm_cfg, out, "cuda", torch.bfloat16, seed=0)
        if not isinstance(trainer.train_batches.dataset, TextImageDataset):
            raise AssertionError("the DAMSM trainer did not read the tree")
        for workers in (damsm_cfg.WORKERS, 8):
            trainer.train_batches.close()
            trainer.train_batches.num_workers = workers
            reset()
            trainer.train_epoch(0)
            torch.cuda.synchronize()
            step0 = trainer.state.step
            t0 = time.perf_counter()
            metrics = {}
            for epoch in (1, 2):
                metrics = trainer.train_epoch(epoch)
            torch.cuda.synchronize()
            steps = trainer.state.step - step0
            ms = (time.perf_counter() - t0) / steps * 1e3
            ok = (steps == 2 * len(trainer.train_batches)
                  and all(math.isfinite(v) for v in metrics.values())
                  and not any(LAUNCHES.values()))
            print(f"[{card}] real-data DAMSM step bf16 batch "
                  f"{damsm_cfg.TRAIN.BATCH_SIZE} (damsm/bird.yml, {workers} "
                  f"workers{' = WORKERS' if workers == damsm_cfg.WORKERS else ''}"
                  f", decoded tree; DamsmTrainer.train_epoch, loader and "
                  f"H2D included): {ms:.3f} ms/step over {steps} steps, "
                  f"against {damsm_ms:.3f} ms/step on device-resident "
                  f"synthetic inputs (phase 5f, same call); launches "
                  f"{dict(LAUNCHES)} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"real-data DAMSM steps: {metrics}")
        trainer.train_batches.close()
        del trainer

        # (f) the sweep on the tree, then FID and IS from the directories.
        eval_cfg = cfg_replace(cfg_from_dict(EVAL_CLIP_BIRD), DATA_DIR=tree,
                               TRAIN={"NET_G": ""})
        ev = CondGanTrainer(eval_cfg, "cuda", torch.bfloat16, seed=100,
                            output_dir=os.path.join(tmp, "eval"),
                            split="test")
        b = eval_cfg.TRAIN.BATCH_SIZE
        calls = len(ev.dataset) // b
        reset()
        t0 = time.perf_counter()
        mean, std = ev.sampling("valid", num_rounds=1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        single = os.path.join(tmp, "eval", "valid", "single")
        pngs = sum(len(f) for _, _, f in os.walk(single))
        ok = (LAUNCHES.get("memory_read_fwd") == 2 * calls
              and pngs == calls * b and 0.0 <= mean <= 1.0)
        print(f"[{card}] real-data sweep: sampling() eval_clip_bird.yml "
              f"widths, batch {b}, bf16, {calls} batches of the tree's test "
              f"captions in {seconds:.2f} s: R mean {mean:.4f} std "
              f"{std:.4f} (random weights: meaningless), {pngs} PNGs, "
              f"launches {dict(LAUNCHES)} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("real-data sweep launches, PNGs or R wrong")
        del ev
        real = os.path.join(tree, "CUB_200_2011", "images")
        n_real = sum(len(f) for _, _, f in os.walk(real))
        for module, args, n, key in (
                ("fid_score", ["--path", single, real], pngs + n_real,
                 "FID:"),
                ("inception_score", ["--path", single], pngs, "IS mean:")):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", f"t2igan_torch.{module}", *args],
                capture_output=True, text=True,
                cwd=os.path.dirname(os.path.abspath(__file__)))
            seconds = time.perf_counter() - t0
            lines = proc.stdout.splitlines()
            value = [ln for ln in lines if ln.startswith(key)]
            inner = [float(ln.split(" in ")[-1].split()[0]) for ln in lines
                     if ln.startswith(("statistics of", "scored"))]
            ok = proc.returncode == 0 and value and inner and all(
                math.isfinite(float(x)) for x in value[0].replace(
                    key, "").replace("std:", "").split())
            print(f"[{card}] python -m t2igan_torch.{module} on the card: "
                  f"{value[0] if value else '-'} (random Inception weights: "
                  f"meaningless); {n} images decoded and through Inception "
                  f"in {inner[0] if inner else float('nan'):.2f} s "
                  f"({n / inner[0] if inner else float('nan'):.1f} images/s)"
                  f", {seconds:.2f} s with process start "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{module} failed:\n{proc.stdout}\n"
                                     f"{proc.stderr}")



# ------------------------------------------------------------- phase 8 ----

METRICS_KEYS = {"step", "time", "prefix", "images_per_sec", "sec_per_step"}


def metrics_rows(out_dir):
    """The rows of ``<out_dir>/metrics.jsonl``."""
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def dcgan_cfg(fused: bool, net_g: str = ""):
    """eval_clip_bird.yml with GAN.B_DCGAN (GDCGan: GF 64, R 2, three
    branches, one 256 px image)."""
    from t2igan_torch.config import cfg_replace

    return cfg_replace(fused_cfg(fused), GAN={"B_DCGAN": True},
                       TRAIN={"NET_G": net_g})


def drive_dcgan(card):
    """Phase 8a: GAN.B_DCGAN at the widths of eval_clip_bird.yml.  A
    seeded GDCGan saved with save_generator_pth (a G_DCGAN file) and read
    back through TRAIN.NET_G bitwise; the f32 sampler from that file on
    the card against the CPU (batch 2, TF32 off) and the bf16-vs-f32 gap;
    sampling() one round at the YAML's batch of 10 in both tail settings
    (2 K1 and 2 or 0 K3 launches per sampler call, one PNG per record, R
    in [0, 1]); the sampler timed at batch 128 in bf16 in both tails."""
    import tempfile

    import torch

    from t2igan_torch.data.tokenizer import ClipTokenizer
    from t2igan_torch.generate import build_models
    from t2igan_torch.models.convert import save_generator_pth
    from t2igan_torch.models.factory import build_generator
    from t2igan_torch.models.generator import GDCGan, init_generator_
    from t2igan_torch.ops.kernels import LAUNCHES
    from t2igan_torch.train.steps import make_sampler
    from t2igan_torch.train.train_gan import CondGanTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory(dir=scratch_dir()) as out:
        src = init_generator_(build_generator(dcgan_cfg(False)),
                              torch.Generator().manual_seed(21))
        if not isinstance(src, GDCGan):
            raise AssertionError("GAN.B_DCGAN did not build a GDCGan")
        path = os.path.join(out, "netG_epoch_0.pth")
        save_generator_pth(src, path)

        cfg = dcgan_cfg(False, path)
        tok = ClipTokenizer.load()(CAPTIONS[:2],
                                   max_length=cfg.TEXT.WORDS_NUM)
        noise = torch.Generator().manual_seed(22)
        z = torch.randn((2, cfg.GAN.Z_DIM), generator=noise)
        eps = torch.randn((2, cfg.GAN.CONDITION_DIM), generator=noise)
        runs = {}
        for device, dtype in (("cpu", torch.float32), ("cuda", torch.float32),
                              ("cuda", torch.bfloat16)):
            clip, gen = build_models(cfg, 0, torch.device(device), dtype,
                                     weights=path)
            runs[device, dtype] = [f.float().cpu() for f in make_sampler(
                cfg, clip, gen)(tok["input_ids"], tok["attention_mask"], z,
                                eps)]
            del clip, gen
        if [tuple(f.shape) for f in runs["cuda", torch.float32]] != \
                [(2, 256, 256, 3)]:
            raise AssertionError("GDCGan sampler image shapes")
        # Bound 1e-4 on images in [-1, 1]: f32 throughout (TF32 off), the
        # card's K1 and cuDNN against the CPU's plain read and convs.
        bound = 1e-4
        gap = (runs["cuda", torch.float32][0]
               - runs["cpu", torch.float32][0]).abs().max().item()
        bf16_gap = (runs["cuda", torch.bfloat16][0]
                    - runs["cuda", torch.float32][0]).abs().max().item()
        print(f"dcgan: GDCGan (eval_clip_bird.yml widths, B_DCGAN) from a "
              f"G_DCGAN netG_epoch_0.pth, f32 sampler card vs CPU, batch 2: "
              f"max_abs_diff={gap:.3e} bound={bound:.0e} "
              f"{'ok' if gap <= bound else 'FAIL'}; bf16 vs f32 on the card "
              f"max_abs_diff={bf16_gap:.3e}")
        if not gap <= bound:
            raise AssertionError("GDCGan f32 sampler on the card disagrees "
                                 "with the CPU")

        for fused in (False, True):
            label = "fused tail" if fused else "plain tail"
            ev = CondGanTrainer(dcgan_cfg(fused, path), "cuda",
                                torch.bfloat16, seed=100,
                                output_dir=os.path.join(out, label),
                                split="test")
            held = all(torch.equal(a.cpu(), b) for a, b in zip(
                ev.state.gen_ema.state_dict().values(),
                src.state_dict().values()))
            b = ev.cfg.TRAIN.BATCH_SIZE
            calls = len(ev.dataset) // b
            for name in list(LAUNCHES):
                LAUNCHES[name] = 0
            t0 = time.perf_counter()
            mean, std = ev.sampling("valid", num_rounds=1)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = dict(LAUNCHES)
            single = os.path.join(out, label, "valid", "single")
            pngs = sum(len(f) for _, _, f in os.walk(single))
            want = {"memory_read_fwd": 2 * calls,
                    "reschain": 2 * calls if fused else 0,
                    "memory_read_bwd": 0}
            ok = (held and all(counts.get(k, 0) == v for k, v in want.items())
                  and pngs == calls * b and 0.0 <= mean <= 1.0)
            print(f"dcgan: sampling() {label}, TRAIN.NET_G = the G_DCGAN "
                  f"file (weights held bitwise {held}), batch {b}, bf16, 1 "
                  f"round of {calls} batches in {seconds:.2f} s: R mean "
                  f"{mean:.4f} std {std:.4f}, {pngs} PNGs, launches {counts} "
                  f"(want {want}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("GDCGan sweep: weights, launch counts, "
                                     "PNGs or R wrong")
            del ev

    for fused in (False, True):
        cfg = dcgan_cfg(fused)
        clip, gen = build_models(cfg, 0, torch.device("cuda"),
                                 torch.bfloat16)
        args = bench_inputs(cfg, TIMED_BATCH, clip.cfg.eos_token_id)
        sampler = make_sampler(cfg, clip, gen)
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: sampler(*args), iters=10)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[{card}] GDCGan sampler {'fused' if fused else 'plain'} "
              f"tail bf16 batch {TIMED_BATCH}: {ms:.3f} ms/batch, "
              f"{TIMED_BATCH * 1000.0 / ms:.1f} images/s, peak memory "
              f"{peak:.2f} GiB")
        del clip, gen, sampler


def check_figures():
    """Phase 8b: the port's attention_grid on the committed fixture gives
    the sha256 of the JAX package's PIL grid recorded beside it (this
    machine has no PIL: its one check of the labels); gen_example at the
    widths of eval_clip_bird.yml writes the JAX file names, each stage's
    images and the <s>_a<k>.png grids, read back by the port's decoder."""
    import hashlib
    import tempfile

    import numpy as np
    import torch

    from t2igan_torch.config import cfg_from_dict
    from t2igan_torch.configs import EVAL_CLIP_BIRD
    from t2igan_torch.data.native import decode_image
    from t2igan_torch.train.train_gan import CondGanTrainer
    from t2igan_torch.utils.viz import attention_grid

    testdata = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "t2igan_torch", "testdata")
    with open(os.path.join(testdata, "fixtures.json")) as f:
        record = json.load(f)["attention_grid"]
    with np.load(os.path.join(testdata, record["file"])) as f:
        images, attn = f["images_u8"].astype(np.float32) / 255.0, f["attn"]
    t0 = time.perf_counter()
    grid = attention_grid(images, attn, record["labels"])
    seconds = time.perf_counter() - t0
    sha = hashlib.sha256(grid.tobytes()).hexdigest()
    ok = sha == record["sha256_grid"] and list(grid.shape) == record["shape"]
    print(f"figures: attention_grid of the committed fixture "
          f"{tuple(grid.shape)} in {seconds * 1e3:.1f} ms, sha256 "
          f"{sha[:16]}... equal to PIL's {ok}")
    if not ok:
        raise AssertionError("attention_grid differs from the JAX/PIL grid")

    captions = CAPTIONS[:3]
    with tempfile.TemporaryDirectory(dir=scratch_dir()) as out:
        ev = CondGanTrainer(cfg_from_dict(EVAL_CLIP_BIRD), "cuda",
                            torch.bfloat16, seed=100, output_dir=out,
                            split="test")
        t0 = time.perf_counter()
        ev.gen_example({"demo": captions})
        seconds = time.perf_counter() - t0
        names = sorted(os.listdir(os.path.join(out, "demo")))
        want = sorted([f"0_s_{j}_g{k}.png" for j in range(len(captions))
                       for k in range(3)] + ["0_a0.png", "0_a1.png"])
        shapes = {n: decode_image(os.path.join(out, "demo", n)).shape
                  for n in ("0_s_0_g2.png", "0_a1.png")}
        ok = names == want and shapes == {
            "0_s_0_g2.png": (256, 256, 3),
            "0_a1.png": (len(captions) * 110, 9 * 96, 3)}
        print(f"figures: gen_example (eval_clip_bird.yml widths, bf16, "
              f"{len(captions)} captions) in {seconds:.2f} s wrote {names}; "
              f"shapes {shapes} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("gen_example files")
        del ev


def check_legacy_encoders(card):
    """Phase 8d: the legacy encoders at the reference's widths, f32 (TF32
    off), card against CPU within the CPU tests' bounds, each timed:
    RnnEncoder LSTM and GRU (CUB's 5450 words, 300 inputs, 256 hidden,
    T = 18, ragged lengths 0..18, batch 16; 1e-5), CnnEncoder (299 px, nef
    256, random Inception weights, batch 4; 1e-4) and GlobalAttentionText
    (idf 256 over 17x17 regions, 18 words of 256, padded words; 1e-5)."""
    import copy

    import torch

    from t2igan_torch.models.inception import init_inception_
    from t2igan_torch.models.legacy import (CnnEncoder, GlobalAttentionText,
                                            RnnEncoder)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(31)

    def compare(name, cpu_mod, inputs, tol):
        card_mod = copy.deepcopy(cpu_mod).to("cuda").eval()
        cpu_mod.eval()
        card_in = [x.to("cuda") for x in inputs]
        with torch.no_grad():
            want = cpu_mod(*inputs)
            got = card_mod(*card_in)
            ms = cuda_ms(lambda: card_mod(*card_in), iters=10)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        err = max((a.cpu() - b).abs().max().item() for a, b in zip(got, want))
        ok = all(torch.allclose(a.cpu(), b, rtol=tol, atol=tol)
                 for a, b in zip(got, want))
        print(f"[{card}] legacy {name}: card vs CPU max_abs_diff={err:.3e} "
              f"(rtol = atol = {tol:.0e}) {'ok' if ok else 'FAIL'}; "
              f"{ms:.3f} ms a call on the card")
        if not ok:
            raise AssertionError(f"{name} on the card disagrees with the CPU")

    b, t = 16, 18
    lens = torch.tensor([t, 0, 1] + torch.randint(
        1, t + 1, (b - 3,), generator=g).tolist())
    caps = torch.randint(1, 5450, (b, t), generator=g)
    caps = caps * (torch.arange(t)[None, :] < lens[:, None])
    for rnn_type in ("LSTM", "GRU"):
        enc = RnnEncoder(5450, 300, 256, rnn_type)
        with torch.no_grad():
            for p in enc.parameters():
                p.uniform_(-0.1, 0.1, generator=g)
        compare(f"RnnEncoder {rnn_type} (5450 words, 300 in, 256 hidden, "
                f"T {t}, batch {b})", enc, [caps, lens], 1e-5)

    cnn = CnnEncoder(256)
    init_inception_(cnn.inception, g)
    with torch.no_grad():
        for p in (cnn.emb_features.weight, cnn.emb_cnn_code.weight,
                  cnn.emb_cnn_code.bias):
            p.uniform_(-0.1, 0.1, generator=g)
    images = torch.rand((4, 299, 299, 3), generator=g) * 2 - 1
    compare("CnnEncoder (299 px, nef 256, batch 4)", cnn, [images], 1e-4)

    att = GlobalAttentionText(256, 256)
    with torch.no_grad():
        for p in att.parameters():
            p.normal_(0.0, 256 ** -0.5, generator=g)
    pad = torch.arange(t)[None, :] >= lens[:, None]
    compare(f"GlobalAttentionText (idf 256, 17x17, {t} words, batch {b})",
            att, [torch.randn((b, 17, 17, 256), generator=g),
                  torch.randn((b, t, 256), generator=g), pad], 1e-5)


# ------------------------------------------------------------- phase 9 --
# Data and tensor parallelism.  NCCL refuses two ranks on one card, so on
# a one-card machine the multi-rank runs use gloo with every rank on
# cuda:0, and NCCL runs at world size 1.  The rank programs below are
# module-level functions, which t2igan_torch.parallel.mesh.spawn_local
# starts in processes of their own.

P9_SEED = 7


def p9_gan_cfg(batch):
    from t2igan_torch.config import cfg_from_dict, cfg_replace
    from t2igan_torch.configs import CLIP_BIRD_DMGAN
    return cfg_replace(cfg_from_dict(CLIP_BIRD_DMGAN),
                       TRAIN={"BATCH_SIZE": batch})


def p9_inputs(b, z_dim, c_dim, eos):
    """A global GAN batch of ``b`` rows (the bench's images and caption
    ids, class ids with a same-class pair across the middle) and its z,
    eps1, eps2, all from fixed seeds, on the CPU."""
    import numpy as np
    import torch

    from t2igan_torch.data.synthetic import bench_train_batches

    batch = bench_train_batches(b, eos)[0]
    batch["class_ids"] = (np.arange(b, dtype=np.int32) + 1) // 2
    g = torch.Generator().manual_seed(P9_SEED)
    noise = [torch.randn((b, d), generator=g) for d in (z_dim, c_dim, c_dim)]
    return batch, noise


def p9_rows(x, mesh):
    """This rank's rows of an array, a list of arrays or a batch dict."""
    if isinstance(x, dict):
        return {k: p9_rows(v, mesh) for k, v in x.items()}
    if isinstance(x, list):
        return [p9_rows(v, mesh) for v in x]
    b = x.shape[0] // mesh.world
    return x[mesh.rank * b:(mesh.rank + 1) * b]


def p9_gan_f32(mesh, steps, start=None):
    """One f32 step (SGD lr 0.01, TF32 off) of the clip_bird_dmgan.yml
    trainer at full width on this rank's rows of a global batch of 4, then
    ``steps - 1`` more with drawn noise; from the trainer's seeded G and
    Ds, or from ``start`` (their state dicts, as ``before`` gives them).
    Returns the metrics, the state before, after the first and after the
    last step and the gradients of the first (CPU copies, modules G, EMA
    G, D0-D2), each module's parameter names, and the launches per
    step."""
    import functools

    import torch

    from t2igan_torch.ops.kernels import LAUNCHES
    from t2igan_torch.train.state import init_gan_state
    from t2igan_torch.train.train_gan import CondGanTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = p9_gan_cfg(4)
    trainer = CondGanTrainer(cfg, "cuda", torch.float32, seed=0, mesh=mesh)
    if start is not None:
        for m, sd in zip((trainer.state.gen, *trainer.state.ds),
                         start[:1] + start[2:]):
            m.load_state_dict(sd)
    sgd = functools.partial(torch.optim.SGD, lr=0.01)
    state = init_gan_state(cfg, trainer.state.gen, trainer.state.ds, sgd, sgd)
    batch, noise = p9_inputs(4, cfg.GAN.Z_DIM, cfg.GAN.CONDITION_DIM,
                             trainer.clip.cfg.eos_token_id)
    local = p9_rows(batch, trainer.mesh)
    modules = (state.gen, state.gen_ema, *state.ds)

    def tensors():
        return [{k: t.detach().cpu().clone()
                 for k, t in m.state_dict().items()} for m in modules]

    launches, before = [], tensors()
    for i in range(steps):
        LAUNCHES.clear()
        if i == 0:
            metrics = trainer.step_fn(state, local, *noise)
            first = tensors()
            grads = [{n: p.grad.cpu() for n, p in m.named_parameters()
                      if p.grad is not None} for m in modules]
        else:
            trainer.step_fn(state, local, generator=trainer.noise)
        torch.cuda.synchronize()
        launches.append(dict(LAUNCHES))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "before": before, "after": first, "grads": grads,
            "params": [[n for n, _ in m.named_parameters()]
                       for m in modules],
            "last": tensors(), "launches": launches}


def p9_bf16_step(mesh, batch):
    """The bf16 GAN step of a fresh trainer on this rank's rows of the
    bench's batches of ``batch``, as a function of no arguments, and the
    K1/K2 launches of its first call."""
    import torch

    from t2igan_torch.data.synthetic import bench_train_batches
    from t2igan_torch.ops.kernels import LAUNCHES
    from t2igan_torch.train.train_gan import CondGanTrainer

    cfg = p9_gan_cfg(batch)
    trainer = CondGanTrainer(cfg, "cuda", torch.bfloat16, seed=0, mesh=mesh)
    batches = [{k: ([torch.as_tensor(x, device=trainer.device) for x in v]
                    if k == "images" else torch.as_tensor(
                        v, device=trainer.device))
                for k, v in p9_rows(b, trainer.mesh).items()}
               for b in bench_train_batches(batch,
                                            trainer.clip.cfg.eos_token_id)]
    it = [0]

    def step():
        trainer.step_fn(trainer.state, batches[it[0] % 8],
                        generator=trainer.noise)
        it[0] += 1

    LAUNCHES.clear()
    step()
    torch.cuda.synchronize()
    return step, dict(LAUNCHES)


def p9_world1(mesh):
    """NCCL at world size 1: the f32 step of a trainer with the one-rank
    NCCL group against the same step without a group, twice (the card's
    own run-to-run agreement), and the bf16 b16 step timed both ways.
    The f32 steps run with PyTorch's deterministic algorithms (cuDNN's
    and cuBLAS's own choices otherwise differ from run to run, so two
    runs of one step need not agree bit for bit); the timed steps
    without."""
    import torch

    from t2igan_torch.parallel.mesh import DataMesh

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.benchmark = False
    plain = DataMesh.single(mesh.device)
    out = {"plain": p9_gan_f32(plain, 1), "nccl": p9_gan_f32(mesh, 1),
           "plain_again": p9_gan_f32(plain, 1)}
    torch.use_deterministic_algorithms(False)
    steps = {}
    for name, m in (("plain", plain), ("nccl", mesh)):
        steps[name], out[f"launches_{name}"] = p9_bf16_step(m, TRAIN_BATCH)
    out["ms"] = {name: [] for name in steps}
    for name in ("plain", "nccl", "nccl", "plain"):  # in turns
        out["ms"][name].append(cuda_ms(steps[name], iters=10))
    return out


def p9_dp(mesh):
    """Two gloo ranks on cuda:0: the f32 GAN step over a global batch of 4
    (3 steps), the f32 DAMSM step at damsm/bird.yml's width over a global
    batch of 4, and the bf16 GAN step over the bench's batch of 16
    timed."""
    out = {"gan": p9_gan_f32(mesh, 3), "damsm": p9_damsm_f32(mesh)}
    step, out["launches_bf16"] = p9_bf16_step(mesh, TRAIN_BATCH)
    out["ms"] = cuda_ms(step, iters=10)
    return out


def p9_hold(dp, single):
    """The f32 GAN step over the ranks (``dp``, each rank's result of
    p9_dp or p9_cards) against one process (mesh ``single``) on the same
    4 rows and from the ranks' weights: the orthogonal initializer's QR
    rounds differently at another thread count, so a process that drew
    its own would start elsewhere (ROADMAP F29).  After SGD lr 0.01:
    every parameter and buffer within 1e-4 + 1e-4 |x| (the CPU test's
    bound), each parameter within 1e-3 of its module's largest change
    (phase 4's measure), the metrics within 1e-4 relative; the ranks
    bitwise equal and finite after 3 steps, with 4 K1 + 4 K2 per rank
    per step.  The gap to each tensor's own largest change and gradient
    is printed, not held: a gradient that sums to near zero (a D conv
    bias) keeps only the f32 rounding of its terms, which
    ``python -m t2igan_torch.dp_rounding`` shows falls to ~1e-13 in f64.
    Returns (whether all hold, a line to print)."""
    import torch

    from t2igan_torch.dp_rounding import gaps

    one = p9_gan_f32(single, 1, start=dp[0]["gan"]["before"])
    worst = gaps([r["gan"] for r in dp], one,
                 ("g", "g_ema", "d0", "d1", "d2"))
    last = [r["gan"]["last"] for r in dp]
    equal = all(torch.equal(a[k], b[k]) for r in last[1:]
                for a, b in zip(last[0], r) for k in a) and all(
        bool(torch.isfinite(t).all()) for r in last for m in r
        for t in m.values())
    per_step = [c for r in dp for c in r["gan"]["launches"]]
    launches_ok = all(c.get("memory_read_fwd") == 4
                      and c.get("memory_read_bwd") == 4 for c in per_step)
    ok = (all(worst[k][0] <= 1 for k in ("metrics", "abs_rel",
                                          "module_change"))
          and equal and launches_ok)
    return ok, ("SGD lr 0.01, gap / bound: " + ", ".join(
        f"{k} {v:.3e} ({where})" for k, (v, where) in sorted(worst.items()))
        + " (held to 1: metrics, abs_rel, module_change); ranks bitwise "
        f"equal and finite after 3 steps {equal}; launches per rank per "
        f"step {per_step[:3]}")


def p9_damsm_inputs(b, eos):
    """A DAMSM batch of ``b`` rows at 224 px: random captions of 30 tokens
    of varied length, class ids with a same-class pair across the
    middle."""
    import numpy as np

    rng = np.random.default_rng(P9_SEED)
    views = []
    for _ in range(2):
        ids = np.full((b, 30), eos, np.int32)
        mask = np.zeros((b, 30), np.int32)
        for i, n in enumerate(rng.integers(6, 31, b)):
            ids[i, 0] = eos - 1
            ids[i, 1:n - 1] = rng.integers(1, 40000, n - 2)
            mask[i, :n] = 1
        views.append((ids, mask))
    return {"images": rng.standard_normal((b, 224, 224, 3)).astype(
                np.float32),
            "ids": views[0][0], "mask": views[0][1],
            "ids_2": views[1][0], "mask_2": views[1][1],
            "class_ids": (np.arange(b, dtype=np.int32) + 1) // 2}


def p9_damsm_f32(mesh):
    """The f32 DAMSM loss and its rank-averaged gradients (TF32 off) at
    damsm/bird.yml's width on this rank's rows of a global batch of 4,
    then one DAMSM step; CPU copies."""
    import torch

    from t2igan_torch.config import cfg_from_dict, cfg_replace
    from t2igan_torch.configs import DAMSM_BIRD
    from t2igan_torch.models.clip import init_clip_
    from t2igan_torch.models.factory import build_clip
    from t2igan_torch.train.state import damsm_optimizer, init_damsm_state
    from t2igan_torch.train.steps import make_damsm_loss, make_damsm_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg_replace(cfg_from_dict(DAMSM_BIRD), TRAIN={"BATCH_SIZE": 4})

    def fresh():
        clip = init_clip_(build_clip(), torch.Generator().manual_seed(0))
        return clip.to(mesh.device).requires_grad_(True)

    clip = fresh()
    batch = {k: torch.as_tensor(v, device=mesh.device) for k, v in
             p9_rows(p9_damsm_inputs(4, clip.cfg.eos_token_id),
                     mesh).items()}
    total, metrics = make_damsm_loss(cfg, clip, mesh=mesh)(batch)
    params = list(clip.parameters())
    for p, g in zip(params, torch.autograd.grad(total, params,
                                                allow_unused=True)):
        p.grad = g
    mesh.all_reduce_grads_(params)
    grads = {n: None if p.grad is None else p.grad.cpu()
             for n, p in clip.named_parameters()}
    del clip
    state = init_damsm_state(cfg, fresh(), damsm_optimizer(cfg, 100))
    step = make_damsm_step(cfg, state.clip, state.opt, mesh=mesh)(batch)
    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "grads": grads,
            "step": {k: v.item() for k, v in step.items()},
            "after": {k: v.detach().cpu() for k, v in
                      state.clip.state_dict().items()}}


def p9_sweep(mesh, out):
    """sampling() one round at eval_clip_bird.yml's widths and batch of 10
    in f32 (TF32 off), both tail settings, into ``out``/<tail>: R, the
    hits, the PNGs by name (rank 0 reads them) and the launches per
    sampler call."""
    import numpy as np
    import torch

    from t2igan_torch.config import cfg_from_dict, cfg_replace
    from t2igan_torch.configs import EVAL_CLIP_BIRD
    from t2igan_torch.data import native
    from t2igan_torch.ops.kernels import LAUNCHES
    from t2igan_torch.train.train_gan import CondGanTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    for fused in (False, True):
        tail = "fused" if fused else "plain"
        ev = CondGanTrainer(cfg_replace(cfg_from_dict(EVAL_CLIP_BIRD),
                                        GAN={"FUSED_TAIL": fused}),
                            "cuda", torch.float32, seed=100,
                            output_dir=os.path.join(out, tail), split="test",
                            mesh=mesh)
        LAUNCHES.clear()
        r = ev.sampling("valid", num_rounds=1)
        torch.cuda.synchronize()
        calls = len(ev.dataset) // ev.cfg.TRAIN.BATCH_SIZE
        pngs = {}
        if ev.mesh.rank == 0:
            single = os.path.join(out, tail, "valid", "single")
            for d, _, files in os.walk(single):
                for f in files:
                    path = os.path.join(d, f)
                    pngs[os.path.relpath(path, single)] = np.asarray(
                        native.decode_image(path))
        res[tail] = {"r": r, "hits": list(ev.sweep_hits), "pngs": pngs,
                     "launches": {k: v / calls for k, v in LAUNCHES.items()}}
    return res


def p9_tp(mesh):
    """CLIP ViT-B/32 tensor-parallel over the two ranks (model axis 2):
    the f32 DAMSM loss (TF32 off) on a batch of 4 and its gradients,
    beside the replicated module's on the same rank."""
    import torch

    from t2igan_torch.config import cfg_from_dict, cfg_replace
    from t2igan_torch.configs import DAMSM_BIRD
    from t2igan_torch.models.clip import init_clip_
    from t2igan_torch.models.factory import build_clip
    from t2igan_torch.parallel import tp
    from t2igan_torch.train.steps import make_damsm_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg_replace(cfg_from_dict(DAMSM_BIRD), TRAIN={"BATCH_SIZE": 4})
    clip = init_clip_(build_clip(), torch.Generator().manual_seed(0)).to(
        mesh.device).requires_grad_(True)
    batch = {k: torch.as_tensor(v, device=mesh.device) for k, v in
             p9_damsm_inputs(4, clip.cfg.eos_token_id).items()}

    def loss_and_grads(module, data):
        total, metrics = make_damsm_loss(cfg, module, mesh=data)(batch)
        params = list(module.parameters())
        for p, g in zip(params, torch.autograd.grad(total, params,
                                                    allow_unused=True)):
            p.grad = g
        return metrics

    ref = loss_and_grads(clip, None)
    ref_grads = {n: None if p.grad is None else p.grad.clone()
                 for n, p in clip.named_parameters()}
    data, group = tp.mesh_2d(mesh, 2)
    tp.shard_clip_(clip, group)
    got = loss_and_grads(clip, data)
    tp.all_reduce_grads_(clip, data)
    m = torch.distributed.get_rank(group)
    worst = {"loss": max(abs(got[k].item() - ref[k].item())
                         / max(1.0, abs(ref[k].item())) for k in ref)}
    for n, p in clip.named_parameters():
        if ref_grads[n] is None:
            continue
        want = tp.shard_tensor(n, ref_grads[n], m, 2)
        scale = max(1.0, want.abs().max().item())
        worst[n] = ((p.grad - want).abs()
                    / (1e-4 * (scale + want.abs()))).max().item()
    heads = [layer.self_attn.num_heads for layer in clip.text_model.layers]
    return {"worst": worst, "heads": heads,
            "metrics": {k: v.item() for k, v in got.items()}}


def p9_damsm_step(mesh, batch):
    """The bf16 DAMSM step at damsm/bird.yml's width on this rank's rows
    of the bench's DAMSM batch of ``batch``, as a function of no
    arguments."""
    import torch

    from t2igan_torch.config import cfg_from_dict, cfg_replace
    from t2igan_torch.configs import DAMSM_BIRD
    from t2igan_torch.data.synthetic import bench_damsm_batch
    from t2igan_torch.models.clip import init_clip_
    from t2igan_torch.models.factory import build_clip
    from t2igan_torch.train.state import damsm_optimizer, init_damsm_state
    from t2igan_torch.train.steps import make_damsm_step

    cfg = cfg_replace(cfg_from_dict(DAMSM_BIRD), TRAIN={"BATCH_SIZE": batch})
    clip = init_clip_(build_clip(), torch.Generator().manual_seed(0))
    state = init_damsm_state(cfg, clip.to(mesh.device),
                             damsm_optimizer(cfg, steps_per_epoch=100))
    step = make_damsm_step(cfg, state.clip, state.opt, torch.bfloat16, mesh)
    inputs = {k: torch.as_tensor(v, device=mesh.device) for k, v in p9_rows(
        bench_damsm_batch(batch, clip.cfg.eos_token_id), mesh).items()}
    return lambda: step(inputs)


def p9_cards(mesh):
    """One rank a card over NCCL: the f32 GAN step over a global batch of
    4 (3 steps), and the bf16 GAN step (global batch 16) and DAMSM step
    (global batch 48) timed."""
    out = {"gan": p9_gan_f32(mesh, 3)}
    step, out["launches_bf16"] = p9_bf16_step(mesh, TRAIN_BATCH)
    out["ms"] = cuda_ms(step, iters=10)
    out["damsm_ms"] = cuda_ms(p9_damsm_step(mesh, 48), iters=10)
    return out


def drive_parallel_cards(card, n):
    """Data parallelism over NCCL on ``n`` cards of one host (not part of
    the one-card run): ``torchrun --nproc_per_node n -m
    t2igan_torch.train_gan`` for 3 bf16 steps at a batch of 16; the f32
    GAN step over ``n`` ranks against one process on the same 4 rows (9b's
    bounds) and the ranks bitwise equal after 3 steps; the bf16 GAN step
    at a global batch of 16 and the DAMSM step at 48, each beside the same
    step in one process on one card."""
    import tempfile

    from t2igan_torch.parallel.mesh import DataMesh, spawn_local

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(n), "-m", "t2igan_torch.train_gan", "--cfg",
         "t2igan_torch/configs/clip_bird_dmgan.yml", "--steps", "3",
         "--dtype", "bf16", "--batch", str(TRAIN_BATCH)], cwd=here,
        capture_output=True, text=True, timeout=900)
    steps = [ln for ln in proc.stdout.splitlines() if ln.startswith("[")]
    launches = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("kernel launches: ")]
    print(f"parallel cards: torchrun --nproc_per_node {n} -m t2igan_torch."
          f"train_gan, batch {TRAIN_BATCH}, 3 bf16 steps over NCCL in "
          f"{time.perf_counter() - t0:.1f} s: exit {proc.returncode}; "
          f"{steps}; rank 0 {launches}")
    if proc.returncode != 0:
        print(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise AssertionError("train_gan over NCCL failed")
    with tempfile.TemporaryDirectory(dir=scratch_dir()) as tmp:
        res = spawn_local(p9_cards, n, "nccl", "cuda",
                          os.path.join(tmp, "store"), 900)
    ok, text = p9_hold(res, DataMesh.single("cuda"))
    print(f"parallel cards: {n} NCCL ranks, f32 GAN step at full width over "
          f"a global batch of 4 vs one process: {text} "
          f"{'ok' if ok else 'FAIL'}")
    plain = DataMesh.single("cuda")
    gan_one = cuda_ms(p9_bf16_step(plain, TRAIN_BATCH)[0], iters=10)
    damsm_one = cuda_ms(p9_damsm_step(plain, 48), iters=10)
    print(f"[{card}] parallel cards: bf16 GAN step, global batch "
          f"{TRAIN_BATCH}: {n} NCCL ranks {res[0]['ms']:.3f} ms/step "
          f"({TRAIN_BATCH * 1000.0 / res[0]['ms']:.1f} images/s), one card "
          f"{gan_one:.3f} ms/step; bf16 DAMSM step, global batch 48: {n} "
          f"ranks {res[0]['damsm_ms']:.3f} ms/step, one card "
          f"{damsm_one:.3f} ms/step")
    if not ok:
        raise AssertionError("NCCL data parallelism disagrees")


def drive_parallel(card):
    """Phase 9: data and tensor parallelism on the one card (9a-9e in the
    module docstring)."""
    import tempfile

    import numpy as np
    import torch

    from t2igan_torch.parallel.mesh import DataMesh, spawn_local

    here = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()

    # 9a: the entry point under torchrun at world size 1.
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "t2igan_torch.train_gan", "--cfg",
         "t2igan_torch/configs/clip_bird_dmgan.yml", "--steps", "3",
         "--dtype", "bf16"], cwd=here, capture_output=True, text=True,
        timeout=600)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("kernel launches: ")]
    counts = json.loads(lines[-1].split(": ", 1)[1]) if lines else {}
    ok = (proc.returncode == 0 and counts.get("memory_read_fwd") == 12
          and counts.get("memory_read_bwd") == 12
          and counts.get("reschain", 0) == 0)
    print(f"parallel 9a: torchrun --nproc_per_node 1 -m t2igan_torch."
          f"train_gan, clip_bird_dmgan.yml, 3 bf16 steps in "
          f"{time.perf_counter() - t0:.1f} s: exit {proc.returncode}, "
          f"launches {counts} (want 12 + 12, 4 + 4 a step) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        print(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise AssertionError("train_gan under torchrun failed")

    with tempfile.TemporaryDirectory(dir=scratch_dir()) as tmp:
        # 9a/9e: the one-rank NCCL group.
        t0 = time.perf_counter()
        w1 = spawn_local(p9_world1, 1, "nccl", "cuda",
                         os.path.join(tmp, "store_w1"), 600)[0]
        def differ(x, y):
            """(tensor, max abs diff) where two runs' states differ."""
            return [(k, (a[k] - b[k]).abs().max().item())
                    for a, b in zip(x["after"], y["after"]) for k in a
                    if not torch.equal(a[k], b[k])]

        diff, repeat = differ(w1["plain"], w1["nccl"]), differ(
            w1["plain"], w1["plain_again"])
        same = not diff and w1["plain"]["metrics"] == w1["nccl"]["metrics"]
        print(f"parallel 9a: NCCL group of one rank, f32 step at full width "
              f"(batch 4, SGD lr 0.01, TF32 off, deterministic algorithms) "
              f"vs "
              f"the same step without a group: bitwise {same} "
              f"({len(diff)} tensors differ {diff[:3]}); the plain step "
              f"against itself: {len(repeat)} differ {repeat[:3]}; "
              f"{time.perf_counter() - t0:.1f} s {'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError("the world-1 NCCL step differs from the "
                                 "step without a group")
        for name in ("plain", "nccl"):
            c = w1[f"launches_{name}"]
            if c.get("memory_read_fwd") != 4 or c.get("memory_read_bwd") != 4:
                raise AssertionError(f"{name} bf16 step launched {c}")
        ms = w1["ms"]
        print(f"[{card}] parallel 9e: bf16 train step batch {TRAIN_BATCH}, "
              f"in turns (no group, group, group, no group): no group "
              + " / ".join(f"{v:.3f}" for v in ms["plain"])
              + " ms/step, NCCL group of one "
              + " / ".join(f"{v:.3f}" for v in ms["nccl"])
              + f" ms/step (launches a step {w1['launches_nccl']})")

        # 9b: two gloo ranks on cuda:0 against one process on the card.
        t0 = time.perf_counter()
        dp = spawn_local(p9_dp, 2, "gloo", "cuda:0",
                         os.path.join(tmp, "store_dp"), 900)
        spawn_s = time.perf_counter() - t0
        ok, text = p9_hold(dp, DataMesh.single("cuda"))
        print(f"parallel 9b: 2 gloo ranks on cuda:0, f32 GAN step at full "
              f"width, global batch 4 vs one process on the batch of 4: "
              f"{text} ({spawn_s:.1f} s) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("2-rank GAN step disagrees")
        ref = p9_damsm_f32(DataMesh.single("cuda"))
        worst_dm = max(abs(r["damsm"]["metrics"][k] - ref["metrics"][k])
                       / max(1.0, abs(ref["metrics"][k]))
                       for r in dp for k in ref["metrics"])
        worst_dg = 0.0
        for r in dp:
            for n, w in ref["grads"].items():
                g = r["damsm"]["grads"][n]
                if w is None:
                    continue
                scale = max(1.0, w.abs().max().item())
                worst_dg = max(worst_dg, ((g - w).abs()
                                          / (1e-4 * (scale + w.abs())))
                               .max().item())
        d_equal = all(torch.equal(dp[0]["damsm"]["after"][k],
                                  dp[1]["damsm"]["after"][k])
                      for k in ref["after"])
        ok = worst_dm <= 1e-4 and worst_dg <= 1.0 and d_equal
        print(f"parallel 9b: 2 gloo ranks, f32 DAMSM loss at damsm/bird.yml "
              f"width, global batch 4 vs one process: worst metric rel diff "
              f"{worst_dm:.3e} (bound 1e-4), worst |g - w| / (1e-4 (max(1, "
              f"max |w|) + |w|)) {worst_dg:.3e} (bound 1); CLIP after the "
              f"step bitwise equal on both ranks {d_equal} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("2-rank DAMSM step disagrees")
        print(f"[{card}] parallel 9e: bf16 train step, 2 gloo ranks on one "
              f"card (collectives through host memory), global batch "
              f"{TRAIN_BATCH}: {dp[0]['ms']:.3f} ms/step (launches a step "
              f"per rank {dp[0]['launches_bf16']})")

        # 9c: the sweep over two ranks against one process.
        t0 = time.perf_counter()
        sw = spawn_local(p9_sweep, 2, "gloo", "cuda:0",
                         os.path.join(tmp, "store_sw"), 900,
                         (os.path.join(tmp, "sweep2"),))
        spawn_s = time.perf_counter() - t0
        ref = p9_sweep(DataMesh.single("cuda"), os.path.join(tmp, "sweep1"))
        for tail in ("plain", "fused"):
            a, b = sw[0][tail], ref[tail]
            same_names = sorted(a["pngs"]) == sorted(b["pngs"])
            px = max((np.abs(a["pngs"][k].astype(np.int16)
                             - b["pngs"][k].astype(np.int16)).max()
                      for k in b["pngs"]), default=0) if same_names else -1
            ok = (a["r"] == b["r"] and a["hits"] == b["hits"] ==
                  sw[1][tail]["hits"] and same_names and 0 <= px <= 1)
            print(f"parallel 9c: sampling() {tail} tail over 2 gloo ranks vs "
                  f"one process, eval_clip_bird.yml batch 10, f32: R "
                  f"{a['r'][0]:.4f}/{b['r'][0]:.4f}, {len(a['hits'])} hits "
                  f"equal {a['hits'] == b['hits']}, {len(a['pngs'])} PNG "
                  f"names equal {same_names}, worst pixel {px}; launches a "
                  f"sampler call per rank {sw[0][tail]['launches']} "
                  f"({spawn_s:.1f} s for both tails) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("2-rank sweep differs")

        # 9d: tensor parallelism of ViT-B/32 over the two ranks.
        t0 = time.perf_counter()
        tpr = spawn_local(p9_tp, 2, "gloo", "cuda:0",
                          os.path.join(tmp, "store_tp"), 600)
        loss = max(r["worst"].pop("loss") for r in tpr)
        worst = max(max(r["worst"].values()) for r in tpr)
        top = max(tpr[0]["worst"], key=tpr[0]["worst"].get)
        ok = loss <= 1e-5 and worst <= 1.0 and tpr[0]["heads"][0] == 4
        print(f"parallel 9d: ViT-B/32 tensor-parallel over 2 gloo ranks "
              f"(text heads per rank {tpr[0]['heads'][0]}), f32 DAMSM loss "
              f"vs the replicated CLIP: worst metric rel diff {loss:.3e} "
              f"(bound 1e-5), worst |g - w| / (1e-4 (max(1, max |w|) + "
              f"|w|)) {worst:.3e} (bound 1; {top}) in "
              f"{time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("tensor-parallel CLIP disagrees")
    print(f"parallel: phase 9 in {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------ phase 10 --
# The last of the JAX package's surface: the COCO configuration at full
# width, the long-run checks of tests/test_learning_proof.py and
# tests/test_training_stability.py, a full-width run of 300 steps and the
# quality-parity runbook.

# K3 at the COCO sampler's stage shapes (RESCHAIN_CASES' layout): R = 3.
COCO_RESCHAIN_CASES = [(16, (64, 64), TAIL_CHANNELS, 3, False, True, 0.0),
                       (16, (128, 128), TAIL_CHANNELS, 3, True, False, 0.0)]
# tests/test_learning_proof.py's CFG and tests/test_train_steps.py's CFG
# (the stability check's), as dicts.
PROOF_CFG = {"TREE": {"BASE_SIZE": 64, "BRANCH_NUM": 1},
             "GAN": {"GF_DIM": 8, "DF_DIM": 4, "Z_DIM": 16,
                     "CONDITION_DIM": 16, "R_NUM": 1},
             "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": 16},
             "TRAIN": {"BATCH_SIZE": 8, "SMOOTH": {"LAMBDA": 1.0}}}
STABILITY_CFG = {"TREE": {"BASE_SIZE": 64, "BRANCH_NUM": 2},
                 "GAN": {"GF_DIM": 8, "DF_DIM": 4, "Z_DIM": 16,
                         "CONDITION_DIM": 16, "R_NUM": 1},
                 "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": 16},
                 "TRAIN": {"BATCH_SIZE": 4}}
LONG_RUN_STEPS = 300


def tiny_clip_cfg():
    """tests/test_train_steps.py's TINY_CLIP: two 2-layer towers."""
    from t2igan_torch.models.clip import ClipConfig, ClipTowerConfig

    return ClipConfig(vocab_size=512, max_positions=16, eos_token_id=511,
                      projection_dim=32, image_size=32, patch_size=16,
                      region_dim=32, text=ClipTowerConfig(32, 2, 2, 64),
                      vision=ClipTowerConfig(48, 2, 2, 96))


def caption_batch(rng, b, length, vocab=512, eos=511):
    """tests/test_train_steps.py's ``_caption_batch``: (ids, mask)."""
    import numpy as np

    ids = np.zeros((b, length), dtype=np.int32)
    mask = np.zeros((b, length), dtype=np.int32)
    for i, n in enumerate(rng.integers(4, length + 1, size=b)):
        ids[i, 0] = vocab - 2
        ids[i, 1:n - 1] = rng.integers(1, 400, n - 2)
        ids[i, n - 1:] = eos
        mask[i, :n] = 1
    return ids, mask


def sn_convs(d):
    from t2igan_torch.ops.spectral import SNConv

    return [m for m in d.modules() if isinstance(m, SNConv)]


def spectral_health(ds):
    """(largest |norm(u or v) - 1| over every SN conv, the largest
    spectral estimate u·Wv of each discriminator)."""
    import torch

    off, sigmas = 0.0, []
    with torch.no_grad():
        for d in ds:
            top = 0.0
            for conv in sn_convs(d):
                off = max(off, abs(conv.u.norm().item() - 1.0),
                          abs(conv.v.norm().item() - 1.0))
                w2d = conv.weight.permute(0, 2, 3, 1).reshape(
                    conv.weight.shape[0], -1)
                top = max(top, torch.dot(conv.u, w2d @ conv.v).item())
            sigmas.append(top)
    return off, sigmas


def drive_learning_proof(dtype):
    """10b: tests/test_learning_proof.py on the card: 600 steps of the tiny
    conditional GAN toward 8 flat-colour targets (its CFG, caption batch
    and targets; weights from the port's seeds, the EMA at 0.98), with the
    CPU test's thresholds.  Returns the K1/K2 launches (none: BRANCH_NUM 1
    has no refinement stage)."""
    import numpy as np
    import torch

    from t2igan_torch.config import cfg_from_dict
    from t2igan_torch.ops.kernels import LAUNCHES
    from t2igan_torch.train.steps import make_gan_step, make_sampler
    from t2igan_torch.train.train_gan import CondGanTrainer

    cfg = cfg_from_dict(PROOF_CFG)
    b, steps = cfg.TRAIN.BATCH_SIZE, 600
    t0 = time.perf_counter()
    trainer = CondGanTrainer(cfg, "cuda", dtype, seed=1,
                             clip_cfg=tiny_clip_cfg())
    state = trainer.state
    step = make_gan_step(cfg, trainer.clip, dtype, ema_decay=0.98)
    rng = np.random.default_rng(0)
    colors = np.linspace(-0.8, 0.8, b * 3).reshape(b, 3).astype(np.float32)
    targets = torch.from_numpy(np.broadcast_to(
        colors[:, None, None, :], (b, 64, 64, 3)).copy()).cuda()
    ids, mask = (torch.from_numpy(x).cuda()
                 for x in caption_batch(rng, b, 16))
    batch = {"images": [targets], "ids": ids, "mask": mask, "ids_2": ids,
             "mask_2": mask,
             "class_ids": torch.arange(b, dtype=torch.int32, device="cuda")}
    z = torch.randn((b, cfg.GAN.Z_DIM), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(7))
    eps = torch.zeros((b, cfg.GAN.CONDITION_DIM), device="cuda")

    def dist(gen):
        fakes = make_sampler(cfg, trainer.clip, gen)(ids, mask, z, eps)
        return torch.mean((fakes[-1].float() - targets) ** 2).item()

    start = dist(state.gen), dist(state.gen_ema)
    noise = torch.Generator(device="cuda").manual_seed(3)
    for kernel in list(LAUNCHES):
        LAUNCHES[kernel] = 0
    d_losses, g_losses, ws_losses = [], [], []
    for _ in range(steps):
        m = step(state, batch, generator=noise)
        d_losses.append(m["d_loss0"].item())
        g_losses.append(m["g_loss"].item())
        ws_losses.append(m["w_loss"].item() + m["s_loss"].item())
    launches = dict(LAUNCHES)
    end = dist(state.gen), dist(state.gen_ema)
    ws0, ws1 = np.mean(ws_losses[:50]), np.mean(ws_losses[-50:])
    checks = {
        "finite": bool(np.isfinite(d_losses).all()
                       and np.isfinite(g_losses).all()
                       and np.isfinite(ws_losses).all()),
        "G distance < 0.65x": end[0] < 0.65 * start[0],
        "EMA distance < 0.65x": end[1] < 0.65 * start[1],
        "w + s < 0.7x": ws1 < 0.7 * ws0,
        "D loss falls": np.mean(d_losses[-50:]) < np.mean(d_losses[:50]),
        "G loss falls": np.mean(g_losses[-100:]) < np.mean(g_losses[100:200])}
    ok = all(checks.values()) and not any(launches.values())
    print(f"long run 10b: learning proof {str(dtype)[6:]}, {steps} steps in "
          f"{time.perf_counter() - t0:.1f} s: distance G {start[0]:.4f} -> "
          f"{end[0]:.4f}, EMA G {start[1]:.4f} -> {end[1]:.4f}; w + s "
          f"{ws0:.3f} -> {ws1:.3f}; D {np.mean(d_losses[:50]):.3f} -> "
          f"{np.mean(d_losses[-50:]):.3f}; G (100-200 -> last 100) "
          f"{np.mean(g_losses[100:200]):.3f} -> "
          f"{np.mean(g_losses[-100:]):.3f}; launches {launches} (want none);"
          f" {checks} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"learning proof in {dtype} failed: {checks}")
    return launches


def drive_stability(dtype):
    """10b: tests/test_training_stability.py on the card: 60 steps of the
    tiny GAN of tests/test_train_steps.py (two scales, batch 4, weights
    from the port's seeds, a fresh random batch a step), with the CPU
    test's thresholds; 2 K1 + 2 K2 launches a step (one refinement stage,
    two caption views)."""
    import numpy as np
    import torch

    from t2igan_torch.config import cfg_from_dict
    from t2igan_torch.ops.kernels import LAUNCHES
    from t2igan_torch.train.train_gan import CondGanTrainer

    cfg = cfg_from_dict(STABILITY_CFG)
    b, steps = cfg.TRAIN.BATCH_SIZE, 60
    t0 = time.perf_counter()
    trainer = CondGanTrainer(cfg, "cuda", dtype, seed=1,
                             clip_cfg=tiny_clip_cfg())
    rng = np.random.default_rng(0)
    noise = torch.Generator(device="cuda").manual_seed(7)
    for kernel in list(LAUNCHES):
        LAUNCHES[kernel] = 0
    g_losses, d_losses = [], []
    for _ in range(steps):
        ids, mask = caption_batch(rng, b, 16)
        ids2, mask2 = caption_batch(rng, b, 16)
        batch = {"images": [torch.from_numpy(rng.standard_normal(
                     (b, s, s, 3)).astype(np.float32) * 0.3).cuda()
                     for s in (64, 128)],
                 "ids": ids, "mask": mask, "ids_2": ids2, "mask_2": mask2,
                 "class_ids": rng.integers(0, 3, b).astype(np.int32)}
        m = trainer.step_fn(trainer.state, batch, generator=noise)
        g_losses.append(m["g_loss"].item())
        d_losses.append(m["d_loss0"].item() + m["d_loss1"].item())
    launches = dict(LAUNCHES)
    off, sigmas = spectral_health(trainer.state.ds)
    finite = all(torch.isfinite(p).all().item()
                 for p in trainer.state.gen.parameters())
    want = {"memory_read_fwd": 2 * steps, "memory_read_bwd": 2 * steps}
    ok = (np.isfinite(g_losses).all() and np.isfinite(d_losses).all()
          and min(d_losses[-10:]) > 1e-3 and finite and off <= 1e-3
          and all(launches.get(k) == v for k, v in want.items())
          and launches.get("reschain", 0) == 0)
    print(f"long run 10b: stability {str(dtype)[6:]}, {steps} steps in "
          f"{time.perf_counter() - t0:.1f} s: G loss {g_losses[0]:.3f} -> "
          f"{g_losses[-1]:.3f}, D loss {d_losses[0]:.3f} -> "
          f"{d_losses[-1]:.3f}, min D over the last 10 "
          f"{min(d_losses[-10:]):.4f} (> 1e-3), G parameters finite "
          f"{finite}, spectral vectors' largest |norm - 1| {off:.2e} "
          f"(<= 1e-3), largest spectral estimate per D "
          f"{[round(x, 4) for x in sigmas]}; launches {launches} (want "
          f"{want}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"stability check in {dtype} failed")
    return launches


def cub_sources():
    """The committed CUB-sized JPEG fixtures."""
    testdata = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "t2igan_torch", "testdata")
    return sorted(os.path.join(testdata, name)
                  for name in os.listdir(testdata)
                  if name.startswith("cub_") and name.endswith(".jpg"))


def drive_long_run(card):
    """10c: 300 bf16 CondGanTrainer steps at clip_bird_dmgan.yml's widths,
    batch 16, on phase 7's CUB-shaped tree (8 loader workers): finite
    losses and parameters, unit spectral vectors, min(D loss) over the
    last 50 steps > 1e-3, 4 K1 + 4 K2 a step; the trajectory every 25
    steps."""
    import tempfile

    import numpy as np
    import torch

    from t2igan_torch.config import cfg_replace
    from t2igan_torch.data.cub_tree import write_cub_tree
    from t2igan_torch.data.dataset import TextImageDataset
    from t2igan_torch.ops.kernels import LAUNCHES
    from t2igan_torch.train.train_gan import CondGanTrainer

    with tempfile.TemporaryDirectory(dir=scratch_dir()) as tmp:
        tree = write_cub_tree(tmp, cub_sources(), n_train=96, n_test=32,
                              n_classes=8, captions_per_image=10, seed=0)
        cfg = cfg_replace(config("clip_bird_dmgan.yml"), DATA_DIR=tree,
                          WORKERS=8,
                          TRAIN={"BATCH_SIZE": TRAIN_BATCH,
                                 "CLIP_MODEL_CHECKPOINT": ""})
        trainer = CondGanTrainer(cfg, "cuda", torch.bfloat16, seed=0)
        if not isinstance(trainer.dataset, TextImageDataset):
            raise AssertionError("the long run did not read the tree")
        state = trainer.state
        batches = trainer.batches()
        next(batches)  # the loader's first batch, outside the timing
        for kernel in list(LAUNCHES):
            LAUNCHES[kernel] = 0
        rows = []
        t0 = time.perf_counter()
        for i in range(LONG_RUN_STEPS):
            out = trainer.step_fn(state, next(batches),
                                  generator=trainer.noise)
            rows.append({k: v.item() for k, v in out.items()})
            if (i + 1) % 25 == 0:
                r = rows[-1]
                _, sigmas = spectral_health(state.ds)
                print(f"long run 10c: step {i + 1}: D "
                      + " ".join(f"{r[f'd_loss{j}']:.4f}"
                                 for j in range(len(state.ds)))
                      + f", G {r['g_loss']:.4f}, w + s "
                      f"{r['w_loss'] + r['s_loss']:.4f}, KL "
                      f"{r['kl_loss']:.4f}, largest spectral estimate per "
                      f"D {' '.join(f'{x:.4f}' for x in sigmas)}")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(LAUNCHES)
    d_total = [sum(r[f"d_loss{j}"] for j in range(len(state.ds)))
               for r in rows]
    finite_losses = all(math.isfinite(v) for r in rows for v in r.values())
    finite_params = all(torch.isfinite(p).all().item() for m in
                        [state.gen, state.gen_ema, *state.ds]
                        for p in m.parameters())
    off, sigmas = spectral_health(state.ds)
    want = {"memory_read_fwd": 4 * LONG_RUN_STEPS,
            "memory_read_bwd": 4 * LONG_RUN_STEPS}
    ok = (finite_losses and finite_params and off <= 1e-3
          and min(d_total[-50:]) > 1e-3
          and all(launches.get(k) == v for k, v in want.items())
          and launches.get("reschain", 0) == 0)
    print(f"[{card}] long run 10c: {LONG_RUN_STEPS} bf16 steps, batch "
          f"{TRAIN_BATCH}, clip_bird_dmgan.yml widths on the CUB-shaped "
          f"tree: {seconds:.1f} s, {1000 * seconds / LONG_RUN_STEPS:.3f} "
          f"ms/step with the loader; losses finite {finite_losses}, "
          f"parameters finite {finite_params}, spectral vectors' largest "
          f"|norm - 1| {off:.2e}, min D loss over the last 50 "
          f"{min(d_total[-50:]):.4f} (> 1e-3), D loss first/last 25 "
          f"{np.mean(d_total[:25]):.4f} / {np.mean(d_total[-25:]):.4f}; "
          f"launches {launches} (want {want}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the 300-step run failed its checks")


def run_runbook(here, cfg_path, out_dir, extra=()):
    """``python -m t2igan_torch.quality_parity --dry_run`` as a subprocess
    on the card: (exit code, results, launches, seconds, output)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "t2igan_torch.quality_parity", "--dry_run",
         "--cfg", cfg_path, "--output_dir", out_dir, *extra], cwd=here,
        capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    results, launches = {}, {}
    if "{" in lines:
        start = lines.index("{")
        results = json.loads("\n".join(lines[start:lines.index("}", start)
                                             + 1]))
    for line in lines:
        if line.startswith("kernel launches: "):
            launches = json.loads(line.split(": ", 1)[1])
    return proc.returncode, results, launches, seconds, proc


def drive_runbook(card):
    """10d: the quality-parity runbook's dry run on the card with the plain
    and the fused tail (synthetic data, random weights, batch 8, one
    round, 64 images): FID of the images against themselves within 1e-6
    of 0, IS in [1, 1000], R in [0, 1], 2 K1 (and 2 K3 fused) a sweep
    batch; the fused call with ``--write_baseline`` writes its block to
    the named file, and the checkout's BASELINE.md stays as it was."""
    import hashlib
    import tempfile

    from t2igan_torch import configs

    here = os.path.dirname(os.path.abspath(__file__))
    baseline = os.path.join(here, "BASELINE.md")

    def sha():
        with open(baseline, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    before = sha()
    batches = 64 // 8
    with tempfile.TemporaryDirectory(dir=scratch_dir()) as tmp:
        fused_path = os.path.join(tmp, "eval_clip_bird_fused.yml")
        with open(fused_path, "w") as f:  # JSON is YAML
            json.dump(dict(configs.EVAL_CLIP_BIRD, GAN=dict(
                configs.EVAL_CLIP_BIRD["GAN"], FUSED_TAIL=True)), f)
        block = os.path.join(tmp, "baseline.md")
        for fused, cfg_path, extra in (
                (False, "t2igan_torch/configs/eval_clip_bird.yml", ()),
                (True, fused_path, ("--write_baseline", block))):
            rc, res, launches, seconds, proc = run_runbook(
                here, cfg_path, os.path.join(tmp, f"run{int(fused)}"), extra)
            want = {"memory_read_fwd": 2 * batches,
                    "reschain": 2 * batches if fused else 0}
            ok = (rc == 0 and abs(res.get("fid", math.nan)) <= 1e-6
                  and 1.0 <= res.get("is_mean", 0.0) <= 1000.0
                  and 0.0 <= res.get("r_precision_mean", -1.0) <= 1.0
                  and all(launches.get(k, 0) == v for k, v in want.items())
                  and launches.get("memory_read_bwd", 0) == 0)
            print(f"[{card}] runbook 10d: python -m "
                  f"t2igan_torch.quality_parity --dry_run "
                  f"{'fused tail, --write_baseline' if fused else 'plain tail'}"
                  f": exit {rc} in {seconds:.1f} s (phases "
                  f"{ {k: round(v, 1) for k, v in res.get('seconds', {}).items()} }"
                  f" s); FID(X, X) {res.get('fid')!r} (|FID| <= 1e-6), IS "
                  f"{res.get('is_mean')!r} +- {res.get('is_std')!r}, R "
                  f"{res.get('r_precision_mean')!r} +- "
                  f"{res.get('r_precision_std')!r}; launches {launches} "
                  f"(want {want}) {'ok' if ok else 'FAIL'}")
            if not ok:
                print(proc.stdout[-4000:] + proc.stderr[-4000:])
                raise AssertionError("the runbook's dry run failed")
        with open(block) as f:
            text = f.read()
    ok = (text.startswith("\n### Quality parity run — ")
          and "DRY RUN — synthetic data, random weights" in text
          and text.count("### Quality parity run") == 1 and sha() == before)
    print(f"runbook 10d: --write_baseline wrote {len(text)} bytes, one "
          f"block; BASELINE.md unchanged {sha() == before} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("--write_baseline wrote the wrong thing")


def drive_last_surface(card, results):
    """Phase 10: (a) COCO at full width, (b) the long-run checks in f32 and
    bf16, (c) 300 full-width bf16 steps on the CUB-shaped tree, (d) the
    quality-parity runbook's dry run; each part's wall time."""
    import torch

    t_phase = t0 = time.perf_counter()
    drive_sampler("eval_clip_coco.yml")
    drive_fused_sampler(None, "eval_clip_coco.yml")
    worst = check_reschain_cases(COCO_RESCHAIN_CASES, seed=300)
    results["reschain"]["max_abs_err"] = max(
        results["reschain"]["max_abs_err"], worst)
    drive_train_path(None, "clip_coco_dmgan.yml")
    time_sampler(card, "eval_clip_coco.yml", geneval=False)
    time_reschain(card, None, n_res=3)
    print(f"phase 10a (COCO, R_NUM 3): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        drive_learning_proof(dtype)
        drive_stability(dtype)
    print(f"phase 10b (learning proof, stability): "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    drive_long_run(card)
    print(f"phase 10c (300 steps): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    drive_runbook(card)
    print(f"phase 10d (runbook): {time.perf_counter() - t0:.1f} s")
    print(f"phase 10 in {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from t2igan_torch.ops.kernels import build

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    seconds = build.build(build.SOURCES)
    print(f"build {len(seconds)} sources with nvcc in parallel: "
          f"{time.perf_counter() - t0:.1f} s")
    for name in build.SOURCES:
        lib = build.library_path(name)
        log = lib.with_name(lib.name + ".log").read_text().splitlines()
        regs = [int(line.split("Used")[1].split()[0]) for line in log
                if "Used" in line]
        spills = sum(int(line.split("bytes spill stores")[0].split(",")[-1])
                     for line in log if "bytes spill stores" in line)
        print(f"build {name}.cu: {seconds[name]:.1f} s -> {lib.name}; ptxas: "
              f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
              f"{spills} bytes of spill stores")
        if name == "reschain":
            print("build reschain.cu kernels (registers, spill stores): "
                  + ", ".join(f"{k} {r} ({b} B)"
                              for k, r, b in ptxas_kernels(log)))
            # e.g. wgmma products that ptxas had to serialize
            warnings = [line.strip() for line in log if "warning" in line]
            if warnings:
                print("build reschain.cu ptxas warnings: "
                      + " | ".join(warnings))

    results = {
        "memory_read_fwd": {
            "name": "memory_read_fwd", "route": "cuda",
            "source": "t2igan_torch/csrc/memory_read.cu",
            "replaces": "t2igan/ops/pallas/memory_read.py:41"},
        "memory_read_bwd": {
            "name": "memory_read_bwd", "route": "cuda",
            "source": "t2igan_torch/csrc/memory_read_bwd.cu",
            "replaces": "t2igan/ops/pallas/memory_read.py:122"},
        "reschain": {
            "name": "reschain", "route": "cuda",
            "source": "t2igan_torch/csrc/reschain.cu",
            "replaces": "t2igan/ops/pallas/reschain.py:176"},
        "batchnorm": {
            "name": "batchnorm", "route": "cuda",
            "source": "t2igan_torch/csrc/batchnorm.cu",
            "replaces": "none (train-mode BN; t2igan/ops/image.py:242 "
                        "phase_batch_stats)"}}
    def timed(fn, *args):
        """fn(*args), its wall time printed: the script must end within
        its time limit."""
        t = time.perf_counter()
        out = fn(*args)
        print(f"wall time: {fn.__name__} {time.perf_counter() - t:.1f} s, "
              f"{time.perf_counter() - t0:.1f} s since the build began")
        return out

    timed(check_memory_read, results)
    timed(check_memory_read_bwd, results)
    timed(check_reschain, results)
    timed(check_batchnorm, card, results)
    timed(drive_sampler)
    timed(drive_fused_sampler, results)
    timed(drive_geneval)
    timed(drive_train_path, results)
    timed(check_train_step_card_vs_cpu)
    timed(check_gan_graphs, card)
    timed(check_gan_graphs, card, "clip_coco_dmgan.yml", "f32")
    timed(drive_damsm_path)
    timed(check_damsm_step_card_vs_cpu)
    timed(drive_checkpoint_loop, card)
    timed(time_sampler, card)
    step_ms = timed(time_train_step, card)
    damsm_ms = timed(time_damsm_step, card)
    f32_rows = {}
    timed(time_memory_read, card, results, f32_rows)
    timed(time_memory_read_bwd, card, results, step_ms, f32_rows)
    timed(time_reschain, card, results)
    timed(time_f32_paths, card, f32_rows)
    print(json.dumps({"f32_rows": f32_rows}))
    timed(drive_real_data, card, step_ms, damsm_ms["bf16"])
    timed(drive_dcgan, card)
    timed(check_figures)
    timed(check_legacy_encoders, card)
    timed(drive_parallel, card)
    timed(drive_last_surface, card, results)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in results.values()]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
