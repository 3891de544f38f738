#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card.  It imports
``t2igan_torch`` (never JAX or the ``t2igan`` package) and:

1. prints the card's name and power limit, builds every CUDA kernel with
   ``nvcc`` (one process per source, in parallel) and prints the build
   times and the ptxas registers and spills;
2. holds each kernel to its plain PyTorch version on the card, at the
   paths' shapes and at the edges of what the kernel takes, f32 and bf16,
   masked and unmasked, with ragged pixel counts, and prints the error
   beside its stated tolerance: the memory-read forward (K1), and the
   memory-read backward (K2) with its zero gradients at padding, its
   run-to-run determinism and the ``MemoryRead`` autograd pairing;
3. drives the sampler: ``t2igan_torch.generate.generate`` at the widths of
   ``t2igan_torch/configs/eval_clip_bird.yml`` (full ViT-B/32 text tower,
   weights from a seed) on caption requests at the YAML's batch of 10, and
   checks the images and that each sampler call launched K1 exactly twice;
   then holds the f32 sampler on the card to the same sampler on the CPU
   and prints the bf16-vs-f32 gap;
4. drives the train path, this slice's main path: the ``train_gan``
   trainer at the full width of ``configs/clip_bird_dmgan.yml`` takes 3
   bf16 steps at the YAML's batch of 4; it checks finite losses, that G,
   the discriminators, their spectral vectors and the EMA moved, the EMA
   rule, and 4 K1 and 4 K2 launches per step; then holds one f32 step on
   the card to the same step on the CPU at batch 2;
5. times the sampler at batch 128 and the train step at batch 16 (the JAX
   bench's shapes) in bf16, and each kernel beside its plain version, one
   PyTorch library call and its bound, with CUDA events.

It ends with a ``{"kernels": [...]}`` line, the card line and, last,
``{"ok": true, "device": {...}}``.  Any failure raises, and the process
exits non-zero; without a CUDA card it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import math
import os
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

# H100 SXM data-sheet peaks: device memory rate, dense bf16 tensor-core rate,
# f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

# memory read: batch of the timed sampler, of the timed train step, and
# the two refinement stages.
TIMED_BATCH = 128
TRAIN_BATCH = 16
STAGE_HW = ((64, 64), (128, 128))
SLOTS, CHANNELS = 77, 64
F32_UNIT = 2.0 ** -24  # unit roundoff of f32


# (batch, HW, C, L) of the kernel checks: the paths' shapes at batch 16,
# then the edges of what the kernels take (L = 1 and 128, C = 4 and 128,
# odd HW).
KERNEL_CASES = [(16, hw, CHANNELS, SLOTS) for hw in STAGE_HW + ((17, 19),)]
KERNEL_CASES += [(3, (5, 7), 4, 1), (2, (33, 9), 36, 33),
                 (2, (16, 16), 128, 128)]


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


def read_f64(q, k, v, pad):
    """The memory read in float64: how far each f32 version is from exact."""
    import torch

    b, h, w, c = q.shape
    logits = torch.einsum("bqc,blc->bql", q.reshape(b, h * w, c).double(),
                          k.double())
    if pad is not None:
        logits = logits.masked_fill(pad[:, None, :], -1e9)
    return torch.einsum("bql,blc->bqc", logits.softmax(-1),
                        v.double()).reshape(b, h, w, c)


def check_memory_read(results):
    """Phase 2: K1 against memory_read_plain on the card."""
    import torch

    from t2igan_torch.ops.kernels.memory_read import (memory_read_fused,
                                                      memory_read_plain)

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
                scale = ref.abs().max().item()
                if dtype == torch.float32:
                    # C-term f32 dot products of unit normals (logits of
                    # size ~sqrt(C)) summed in another order than cuBLAS.
                    tol = 3e-6 * c
                else:
                    # Both round an f32 result to bf16: one bf16 step of the
                    # largest output (2^-7 relative) apart at most.
                    tol = 2.0 ** -7 * scale + 1e-4
                ok = bool(torch.isfinite(out).all()) and err <= tol
                exact = read_f64(q, k, v, pad)
                vs64 = ((out - exact).abs().max().item(),
                        (ref - exact).abs().max().item())
                print(f"check memory_read_fwd {str(dtype)[6:]} B={b} "
                      f"HW={hw[0]}x{hw[1]} C={c} L={slots} mask={mask}:"
                      f" max_abs_err={err:.3e} tol={tol:.3e} "
                      f"{'ok' if ok else 'FAIL'} (vs float64: kernel "
                      f"{vs64[0]:.3e}, plain {vs64[1]:.3e})")
                if not ok:
                    raise AssertionError("memory_read kernel disagrees with "
                                         "memory_read_plain")
                worst = max(worst, err)
    results["memory_read_fwd"]["max_abs_err"] = worst


def bwd_abs_sums(q, k, v, pad, dout):
    """Sums of the absolute values of the terms that make dq (over the L
    slots), dk and dv (over the HW pixels): what bounds their f32
    rounding error."""
    import torch

    b, h, w, c = q.shape
    qf = q.reshape(b, h * w, c).float()
    g = dout.reshape(b, h * w, c).float()
    logits = torch.einsum("bqc,blc->bql", qf, k.float())
    if pad is not None:
        logits = logits.masked_fill(pad[:, None, :], -1e9)
    attn = logits.softmax(-1)
    dattn = torch.einsum("bqc,blc->bql", g, v.float())
    ds = (attn * (dattn - (attn * dattn).sum(-1, keepdim=True))).abs()
    return (torch.einsum("bql,blc->bqc", ds, k.float().abs()).max().item(),
            torch.einsum("bql,bqc->blc", ds, qf.abs()).max().item(),
            torch.einsum("bql,bqc->blc", attn, g.abs()).max().item())


def check_memory_read_bwd(results):
    """Phase 2b: K2 against memory_read_bwd_plain on the card, its zeros
    at padding and its determinism; MemoryRead against autograd through
    memory_read_plain."""
    import torch

    from t2igan_torch.ops.kernels.memory_read import (MemoryRead,
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
                if dtype == torch.float32:
                    # Recursive f32 sums of n terms are off by at most
                    # n * 2^-24 times the sum of the terms' magnitudes;
                    # n is L for dq and HW for dk/dv, plus the C- and
                    # L-term sums inside each term.
                    n_terms = (slots, hw[0] * hw[1], hw[0] * hw[1])
                    tols = [(n + c + slots) * F32_UNIT * a for n, a in
                            zip(n_terms, bwd_abs_sums(q, k, v, pad, dout))]
                else:
                    # Both round an f32 result to bf16: one bf16 step of
                    # the largest output apart at most (K1's bound).
                    tols = [2.0 ** -7 * r.float().abs().max().item() + 1e-4
                            for r in ref]
                line = []
                ok = True
                for name, o, r, tol in zip(names, out, ref, tols):
                    err = (o.float() - r.float()).abs().max().item()
                    ok &= bool(torch.isfinite(o).all()) and err <= tol
                    worst = max(worst, err)
                    line.append(f"{name} {err:.3e}/{tol:.3e}")
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
    tols = [(n + CHANNELS + SLOTS) * F32_UNIT * a for n, a in
            zip((SLOTS, q.shape[1] * q.shape[2], q.shape[1] * q.shape[2]),
                bwd_abs_sums(q, k, v, pad, dout))]
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


def drive_sampler():
    """Phase 3: the sampler at full width through the generate entry point."""
    import torch

    from t2igan_torch.config import cfg_from_dict
    from t2igan_torch.configs import EVAL_CLIP_BIRD
    from t2igan_torch.generate import build_models, generate
    from t2igan_torch.ops.kernels import LAUNCHES
    from t2igan_torch.train.steps import make_sampler

    cfg = cfg_from_dict(EVAL_CLIP_BIRD)
    batch = cfg.TRAIN.BATCH_SIZE
    captions = [CAPTIONS[i % len(CAPTIONS)] for i in range(2 * batch)]
    out_dir = os.path.join("output", "chip_smoke")
    calls = -(-len(captions) // batch)

    for name in list(LAUNCHES):
        LAUNCHES[name] = 0
    t0 = time.perf_counter()
    images = generate(cfg, captions, out_dir, batch, torch.bfloat16, seed=0,
                      device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = LAUNCHES["memory_read_fwd"]
    print(f"sampler path: generate {len(captions)} captions, batch {batch}, "
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
    print(f"sampler f32 card vs CPU, batch 2: max_abs_diff={gap:.3e} "
          f"bound={bound:.0e} {'ok' if gap <= bound else 'FAIL'}")
    print(f"sampler bf16 vs f32 on the card, batch 2: max_abs_diff="
          f"{bf16_gap:.3e}")
    if not gap <= bound:
        raise AssertionError("f32 sampler on the card disagrees with the CPU")


def drive_train_path(results):
    """Phase 4a: 3 bf16 steps of the train_gan trainer at the full width
    of clip_bird_dmgan.yml, the YAML's batch of 4."""
    import torch

    from t2igan_torch.config import cfg_from_dict
    from t2igan_torch.configs import CLIP_BIRD_DMGAN
    from t2igan_torch.ops.kernels import LAUNCHES
    from t2igan_torch.train.train_gan import CondGanTrainer

    cfg = cfg_from_dict(CLIP_BIRD_DMGAN)
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
    for name in list(LAUNCHES):
        LAUNCHES[name] = 0
    t0 = time.perf_counter()
    per_step = []
    for _ in range(3):
        before = {k: t.detach().clone() for k, t in snap().items()}
        counts = dict(LAUNCHES)
        metrics = trainer.train(1)
        torch.cuda.synchronize()
        per_step.append({k: LAUNCHES[k] - counts.get(k, 0)
                         for k in LAUNCHES})
        bad = [k for k, val in metrics.items() if not math.isfinite(val)]
        if bad:
            raise AssertionError(f"non-finite metrics {bad}")
    seconds = time.perf_counter() - t0
    for name in ("memory_read_fwd", "memory_read_bwd"):
        results[name]["launches"] = LAUNCHES[name]
    print(f"train path: train_gan, clip_bird_dmgan.yml full width, batch "
          f"{cfg.TRAIN.BATCH_SIZE}, bf16, 3 steps in {seconds:.2f} s "
          f"(set-up {setup:.2f} s); launches {dict(LAUNCHES)}, per step "
          f"{per_step}; last metrics "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(metrics.items())))
    if any(c.get("memory_read_fwd") != 4 or c.get("memory_read_bwd") != 4
           for c in per_step):
        raise AssertionError("expected 4 memory_read_fwd and 4 "
                             "memory_read_bwd launches per train step")
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


def check_train_step_card_vs_cpu():
    """Phase 4b: one f32 step (TF32 off) on the card against the same step
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


def time_train_step(card):
    """Phase 5b: the train step at batch 16 in bf16, the JAX bench's train
    shape (GF 64, DF 32, R 2, 3 scales, full CLIP, lr 2e-5, 8 fixture
    batches)."""
    import torch

    from t2igan_torch.config import cfg_from_dict, cfg_replace
    from t2igan_torch.configs import CLIP_BIRD_DMGAN
    from t2igan_torch.data.synthetic import bench_train_batches
    from t2igan_torch.train.train_gan import CondGanTrainer

    cfg = cfg_replace(cfg_from_dict(CLIP_BIRD_DMGAN),
                      TRAIN={"BATCH_SIZE": TRAIN_BATCH,
                             "DISCRIMINATOR_LR": 2e-5,
                             "GENERATOR_LR": 2e-5})
    trainer = CondGanTrainer(cfg, "cuda", torch.bfloat16, seed=0)
    batches = [{k: ([torch.as_tensor(x, device="cuda") for x in v]
                    if k == "images" else torch.as_tensor(v, device="cuda"))
                for k, v in batch.items()}
               for batch in bench_train_batches(
                   TRAIN_BATCH, trainer.clip.cfg.eos_token_id)]
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
    print(f"[{card}] train step bf16 batch {TRAIN_BATCH}: {ms:.3f} ms/step, "
          f"{1000.0 / ms:.2f} steps/s, {TRAIN_BATCH * 1000.0 / ms:.1f} "
          f"images/s, peak memory {peak:.2f} GiB; losses after {it[0]} "
          f"steps finite {finite}")
    if not finite:
        raise AssertionError("train step losses not finite")
    return ms


def time_memory_read_bwd(card, results, step_ms):
    """Phase 5d: K2 against memory_read_bwd_plain and the SDPA backward at
    each stage shape of the timed train step, beside the bound."""
    import torch
    import torch.nn.functional as F

    from t2igan_torch.ops.kernels.memory_read import (memory_read_bwd,
                                                      memory_read_bwd_plain)

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
            keep = (~pad)[:, None, None, :]
            q4 = q.view(b, 1, n, CHANNELS).detach().requires_grad_()
            k4 = k[:, None].detach().requires_grad_()
            v4 = v[:, None].detach().requires_grad_()
            d4 = dout.view(b, 1, n, CHANNELS)

            def sdpa():
                return F.scaled_dot_product_attention(q4, k4, v4,
                                                      attn_mask=keep,
                                                      scale=1.0)

            ms = cuda_ms(lambda: memory_read_bwd(q, k, v, pad, dout),
                         iters=20)
            plain = cuda_ms(lambda: memory_read_bwd_plain(q, k, v, pad,
                                                          dout), iters=5)
            fwd = cuda_ms(sdpa, iters=20)
            both = cuda_ms(lambda: torch.autograd.grad(sdpa(), (q4, k4, v4),
                                                       d4), iters=20)
            lib = both - fwd
            print(f"[{card}] memory_read_bwd {name} B={b} HW={hw[0]}x{hw[1]} "
                  f"C={CHANNELS} L={SLOTS}: kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, sdpa backward {lib:.4f} ms (fwd+bwd "
                  f"{both:.4f} - fwd {fwd:.4f}), bound {bound:.4f} ms (bytes "
                  f"{nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, "
                  f"{flops / 1e9:.2f} GFLOP -> {t_ops:.4f} ms), "
                  f"{bound / ms:.1%} of bound")
            if name == "bf16":
                for key, val in (("ms", ms), ("plain_ms", plain),
                                 ("bound_ms", bound), ("library_ms", lib)):
                    totals[key] += val
                results["memory_read_bwd"]["bound_by"] = (
                    "bytes" if t_bytes >= t_ops else "operations")
    results["memory_read_bwd"].update(totals)
    # Two caption views per step, each one launch per stage shape.
    share = 2 * totals["ms"] / step_ms
    print(f"[{card}] K2 in the bf16 batch-{TRAIN_BATCH} train step: 4 "
          f"launches, {2 * totals['ms']:.3f} ms of {step_ms:.3f} ms/step "
          f"({share:.1%}), timed apart")


def time_sampler(card):
    """Phase 5a: sampler ms/batch at batch 128 in bf16, the JAX bench's
    gen shape and inputs (ids all <eos>, full mask)."""
    import torch

    from t2igan_torch.config import cfg_from_dict
    from t2igan_torch.configs import EVAL_CLIP_BIRD
    from t2igan_torch.generate import build_models
    from t2igan_torch.train.steps import make_sampler

    cfg = cfg_from_dict(EVAL_CLIP_BIRD)
    clip, gen = build_models(cfg, 0, torch.device("cuda"), torch.bfloat16)
    sample = make_sampler(cfg, clip, gen)
    b, w = TIMED_BATCH, cfg.TEXT.WORDS_NUM
    ids = torch.full((b, w), clip.cfg.eos_token_id, dtype=torch.int32,
                     device="cuda")
    mask = torch.ones((b, w), dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    z = torch.randn((b, cfg.GAN.Z_DIM), generator=g, device="cuda")
    eps = torch.randn((b, cfg.GAN.CONDITION_DIM), generator=g, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: sample(ids, mask, z, eps), iters=10)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[{card}] sampler bf16 batch {b}: {ms:.3f} ms/batch, "
          f"{b * 1000.0 / ms:.1f} images/s, peak memory {peak:.2f} GiB")


def time_memory_read(card, results):
    """Phase 5c: K1 against memory_read_plain and SDPA at each stage shape
    of the timed sampler, beside the bound."""
    import torch
    import torch.nn.functional as F

    from t2igan_torch.ops.kernels.memory_read import (memory_read_fused,
                                                      memory_read_plain)

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
            keep = (~pad)[:, None, None, :]
            q4, k4, v4 = q.view(b, 1, n, CHANNELS), k[:, None], v[:, None]
            ms = cuda_ms(lambda: memory_read_fused(q, k, v, pad), iters=20)
            plain = cuda_ms(lambda: memory_read_plain(q, k, v, pad), iters=5)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=keep, scale=1.0), iters=20)
            print(f"[{card}] memory_read_fwd {name} B={b} HW={hw[0]}x{hw[1]} "
                  f"C={CHANNELS} L={SLOTS}: kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound {bound:.4f} ms "
                  f"(bytes {nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, "
                  f"{flops / 1e9:.2f} GFLOP -> {t_ops:.4f} ms), "
                  f"{bound / ms:.1%} of bound")
            if name == "bf16":
                for key, val in (("ms", ms), ("plain_ms", plain),
                                 ("bound_ms", bound), ("library_ms", lib)):
                    totals[key] += val
                results["memory_read_fwd"]["bound_by"] = (
                    "bytes" if t_bytes >= t_ops else "operations")
    results["memory_read_fwd"].update(totals)


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

    results = {
        "memory_read_fwd": {
            "name": "memory_read_fwd", "route": "cuda",
            "source": "t2igan_torch/csrc/memory_read.cu",
            "replaces": "t2igan/ops/pallas/memory_read.py:41"},
        "memory_read_bwd": {
            "name": "memory_read_bwd", "route": "cuda",
            "source": "t2igan_torch/csrc/memory_read_bwd.cu",
            "replaces": "t2igan/ops/pallas/memory_read.py:122"}}
    check_memory_read(results)
    check_memory_read_bwd(results)
    drive_sampler()
    drive_train_path(results)
    check_train_step_card_vs_cpu()
    time_sampler(card)
    step_ms = time_train_step(card)
    time_memory_read(card, results)
    time_memory_read_bwd(card, results, step_ms)

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
