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
   launches per step; then holds one f32 step on the card to the same
   step on the CPU at batch 2;
5. times the sampler and gen+eval at batch 128 in both tail settings and
   the train step at batch 16 (the JAX bench's shapes) in bf16, and each
   kernel beside its plain version, its bound and one PyTorch library
   call where one computes the same function (K3 has none; the port's
   unfused eval module chain for the same tail is timed beside it, and
   cuDNN for each of its conv kinds, as a yardstick), with CUDA events.  The kernel rows are device times: the calls are queued
   behind a sleep kernel, so the card runs them back to back whatever the
   host takes to launch them; the host time of a wrapper call is printed
   beside them.

It ends with a ``{"kernels": [...]}`` line, the card line and, last,
``{"ok": true, "device": {...}}``.  Any failure raises, and the process
exits non-zero; without a CUDA card it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import math
import os
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
                  (2, (16, 16), 2 * TAIL_CHANNELS, 1, True, True, 0.0)]


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
                    # C-term f32 dot products of unit normals (logits of
                    # size ~sqrt(C)) summed in another order than cuBLAS.
                    tol = 3e-6 * c
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
                exact, sums, _ = grads_f64(q, k, v, pad, dout)
                if dtype == torch.float32:
                    # Recursive f32 sums of n terms are off by at most
                    # n * 2^-24 times the sum of the terms' magnitudes;
                    # n is L for dq and HW for dk/dv, plus the C- and
                    # L-term sums inside each term.
                    n_terms = (slots, hw[0] * hw[1], hw[0] * hw[1])
                    tols = [(n + c + slots) * F32_UNIT * a.max().item()
                            for n, a in zip(n_terms, sums)]
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
    tols = [(n + CHANNELS + SLOTS) * F32_UNIT * a.max().item() for n, a in
            zip((SLOTS, q.shape[1] * q.shape[2], q.shape[1] * q.shape[2]),
                grads_f64(q, k, v, pad, dout)[1])]
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

    from t2igan_torch.ops.kernels.reschain import (resblock_chain_up_fused,
                                                   resblock_chain_up_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for i, (b, hw, c, n_res, rgb, want_h, shift) in enumerate(
                RESCHAIN_CASES):
            x, rb, up, head = reschain_inputs(b, hw, c, n_res, rgb, dtype,
                                              200 + i, shift)
            out = _outputs(resblock_chain_up_fused(x, rb, *up, head, want_h))
            ref = _outputs(resblock_chain_up_plain(x, rb, *up, head, want_h))
            if dtype == torch.bfloat16:
                # The same bf16 values through the plain version in f32:
                # how far each bf16 version is from its exact result.
                f32 = _outputs(resblock_chain_up_plain(
                    x.float(), [[a.float() for a in p] for p in rb],
                    *[a.float() for a in up],
                    None if head is None else head.float(), want_h))
            torch.cuda.synchronize()
            line, ok = [], True
            for name, o, r in zip(("up", "rgb") if want_h else ("rgb",),
                                  out, ref):
                err = (o - r).abs().max().item()
                scale = r.abs().max().item()
                ok &= bool(torch.isfinite(o).all())
                if dtype == torch.float32:
                    # Worst-case f32 rounding of a 9C-term sum, about five
                    # convs deep, times the largest output.
                    tol = 5 * 9 * c * F32_UNIT * scale + 1e-6
                    ok &= err <= tol
                    worst = max(worst, err)
                    line.append(f"{name} {err:.3e}/{tol:.3e}")
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
    results["reschain"]["max_abs_err"] = worst

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
    tol = 5 * 9 * TAIL_CHANNELS * F32_UNIT + 1e-6  # images in [-1, 1]
    print(f"check reschain f32 on folded weights vs the eval module chain, "
          f"B=4 HW={STAGE_HW[1][0]}x{STAGE_HW[1][1]} C={TAIL_CHANNELS} R=2 "
          f"rgb: max_abs_err="
          f"{err:.3e} tol={tol:.3e} {'ok' if err <= tol else 'FAIL'}")
    if not err <= tol:
        raise AssertionError("K3 on folded weights disagrees with the "
                             "module chain")


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


def fused_cfg(fused: bool):
    from t2igan_torch.config import cfg_from_dict, cfg_replace
    from t2igan_torch.configs import EVAL_CLIP_BIRD

    return cfg_replace(cfg_from_dict(EVAL_CLIP_BIRD),
                       GAN={"FUSED_TAIL": fused})


def drive_fused_sampler(results):
    """Phase 3b: the sampler with GAN.FUSED_TAIL through the generate
    entry point, then the f32 fused sampler against the plain-tail one on
    the card with the same weights."""
    import torch

    from t2igan_torch.data.tokenizer import ClipTokenizer
    from t2igan_torch.generate import build_models, generate
    from t2igan_torch.ops.kernels import LAUNCHES
    from t2igan_torch.train.steps import make_sampler

    cfg = fused_cfg(True)
    batch = cfg.TRAIN.BATCH_SIZE
    captions = [CAPTIONS[i % len(CAPTIONS)] for i in range(2 * batch)]
    calls = -(-len(captions) // batch)
    for name in list(LAUNCHES):
        LAUNCHES[name] = 0
    t0 = time.perf_counter()
    images = generate(cfg, captions, None, batch, torch.bfloat16, seed=0,
                      device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    results["reschain"]["launches"] = counts.get("reschain", 0)
    print(f"fused-tail sampler path: generate {len(captions)} captions, "
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
        clip, gen = build_models(fused_cfg(fused), 0, torch.device("cuda"),
                                 dtype)
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
    print(f"fused-tail sampler f32 vs plain-tail sampler f32 on the card, "
          f"batch 2: max_abs_diff={gap:.3e} bound={bound:.0e} "
          f"{'ok' if gap <= bound else 'FAIL'}")
    print(f"fused-tail sampler bf16 vs f32 on the card, batch 2: "
          f"max_abs_diff={bf16_gap:.3e}")
    if not gap <= bound:
        raise AssertionError("fused-tail sampler disagrees with the plain "
                             "tail")


def geneval_models(fused, device, dtype):
    """CLIP, the generator (weights from seed 0) and the FID Inception-v3
    (random weights from seed 7) on ``device`` in ``dtype``."""
    import torch

    from t2igan_torch.generate import build_models
    from t2igan_torch.models.inception import InceptionV3, init_inception_

    clip, gen = build_models(fused_cfg(fused), 0, torch.device(device), dtype)
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


def drive_train_path(results):
    """Phase 4a: 3 bf16 steps of the train_gan trainer at the full width
    of clip_bird_dmgan.yml, the YAML's batch of 4, with GAN.FUSED_TAIL set:
    the fused tail is eval only, so no step may launch K3."""
    import torch

    from t2igan_torch.config import cfg_from_dict, cfg_replace
    from t2igan_torch.configs import CLIP_BIRD_DMGAN
    from t2igan_torch.ops.kernels import LAUNCHES
    from t2igan_torch.train.train_gan import CondGanTrainer

    cfg = cfg_replace(cfg_from_dict(CLIP_BIRD_DMGAN),
                      GAN={"FUSED_TAIL": True})
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
    print(f"train path: train_gan, clip_bird_dmgan.yml full width with "
          f"GAN.FUSED_TAIL, batch "
          f"{cfg.TRAIN.BATCH_SIZE}, bf16, 3 steps in {seconds:.2f} s "
          f"(set-up {setup:.2f} s); launches {dict(LAUNCHES)}, per step "
          f"{per_step}; last metrics "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(metrics.items())))
    if any(c.get("memory_read_fwd") != 4 or c.get("memory_read_bwd") != 4
           or c.get("reschain", 0) != 0 for c in per_step):
        raise AssertionError("expected 4 memory_read_fwd, 4 memory_read_bwd "
                             "and 0 reschain launches per train step")
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


def time_sampler(card):
    """Phase 5a: the sampler, then gen+eval, at batch 128 in bf16, the JAX
    bench's gen shape and inputs, with the plain and the fused tail."""
    import torch

    from t2igan_torch.evaluation.fid import make_gen_activation_fn
    from t2igan_torch.train.steps import make_sampler

    b = TIMED_BATCH
    for fused in (False, True):
        cfg = fused_cfg(fused)
        clip, gen, inception = geneval_models(fused, "cuda", torch.bfloat16)
        args = bench_inputs(cfg, b, clip.cfg.eos_token_id)
        label = "fused tail" if fused else "plain tail"
        for name, fn in (("sampler", make_sampler(cfg, clip, gen)),
                         ("gen+eval", make_gen_activation_fn(
                             cfg, clip, gen, inception))):
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: fn(*args), iters=10)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            print(f"[{card}] {name} {label} bf16 batch {b}: {ms:.3f} "
                  f"ms/batch, {b * 1000.0 / ms:.1f} images/s, peak memory "
                  f"{peak:.2f} GiB")
        del clip, gen, inception


def time_reschain(card, results):
    """Phase 5e: K3 at each stage shape of the timed sampler (batch 128,
    bf16) against resblock_chain_up_plain and, for context, the port's
    eval module chain for the same tail, beside its bound, and cuDNN for
    each conv kind.  K3 runs as the sampler runs it: on operands laid out
    once (``lay_out_operands``; ``NextStageG`` keeps them), through
    ``fused_tail``."""
    import torch

    from t2igan_torch.ops.kernels.reschain import (fused_tail,
                                                   lay_out_operands,
                                                   resblock_chain_up_plain)

    b, c, n_res = TIMED_BATCH, TAIL_CHANNELS, 2
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    chain_total = 0.0
    for hw, rgb in ((STAGE_HW[0], False), (STAGE_HW[1], True)):
        mods, chain = tail_modules(c, n_res, rgb, torch.bfloat16, 11)
        x, _, _, _ = reschain_inputs(b, hw, c, n_res, False, torch.bfloat16,
                                     11)
        rb = [m.fold() for m in mods[:n_res]]
        up = mods[n_res].fold()
        head = mods[-1].fold() if rgb else None
        x_nchw = x.permute(0, 3, 1, 2)
        n = hw[0] * hw[1]
        flops = 2 * b * n * (n_res * 9 * (2 * c * c + c * c) + 16 * c * c)
        nbytes = 2 * (b * n * c + n_res * 9 * 3 * c * c + 9 * c * c) \
            + 4 * (n_res * 6 * c + 2 * c)
        if rgb:
            flops += 2 * b * 4 * n * 9 * (c // 2) * 3
            nbytes += 2 * (9 * (c // 2) * 3 + b * 4 * n * 3)
        else:
            nbytes += 2 * b * 4 * n * (c // 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["bf16"] * 1e3
        bound = max(t_bytes, t_ops)
        with torch.inference_mode():
            ops = lay_out_operands(rb, *up, head, torch.bfloat16)
            ms, host = queued_ms(lambda: fused_tail(x, ops, not rgb), iters=10)
            plain, _ = queued_ms(lambda: resblock_chain_up_plain(
                x, rb, *up, head, not rgb), iters=5)
            mod_ms, _ = queued_ms(lambda: chain(x_nchw), iters=10)
        print(f"[{card}] reschain bf16 B={b} HW={hw[0]}x{hw[1]} C={c} "
              f"R={n_res} {'RGB head only' if rgb else 'features'}: kernel "
              f"{ms:.4f} ms (host {host:.1f} us a call), plain {plain:.4f} ms, "
              f"eval module chain "
              f"{mod_ms:.4f} ms, bound {bound:.4f} ms (bytes "
              f"{nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, "
              f"{flops / 1e12:.3f} TFLOP -> {t_ops:.4f} ms), "
              f"{bound / ms:.1%} of bound, {flops / ms / 1e9:.1f} TFLOP/s")
        for key, val in (("ms", ms), ("plain_ms", plain), ("bound_ms", bound)):
            totals[key] += val
        chain_total += mod_ms
        results["reschain"]["bound_by"] = ("bytes" if t_bytes >= t_ops
                                           else "operations")
        del mods, chain, ops
        time_cudnn_convs(card, x_nchw, rgb)
        del x, x_nchw
    results["reschain"].update(totals)
    # No single PyTorch call computes the fused tail.
    results["reschain"]["library_ms"] = None
    print(f"[{card}] reschain, both stages: kernel {totals['ms']:.3f} ms, "
          f"plain {totals['plain_ms']:.3f} ms, eval module chain "
          f"{chain_total:.3f} ms, bound {totals['bound_ms']:.3f} ms")


def time_cudnn_convs(card, x_nchw, rgb):
    """Each launch kind of K3 at one stage shape: the work of one launch
    and its bound at the card's peak, beside cuDNN (``F.conv2d``,
    channels-last bf16) for the same conv as the module chain runs it, the
    yardstick of that kind: C -> 2C and C -> C 3x3 on x, C -> C over the
    nearest-2x map (K3's four subpixel phases do 4/9 of its flops), the
    head C/2 -> 3 on the 2x map (bound by the bytes it reads).  The port
    never calls these."""
    import torch
    import torch.nn.functional as F

    b, c, h, w = x_nchw.shape
    n = h * w
    g = torch.Generator(device="cuda").manual_seed(12)

    def weight(cout, cin):
        return (torch.randn((cout, cin, 3, 3), generator=g, device="cuda")
                * (9 * cin) ** -0.5).to(torch.bfloat16).contiguous(
                    memory_format=torch.channels_last)

    def ops_ms(flops):
        return flops / PEAK_FLOPS["bf16"] * 1e3

    x2 = F.interpolate(x_nchw, scale_factor=2, mode="nearest").contiguous(
        memory_format=torch.channels_last)
    # (kind, K3's flops a launch, its bound ms, cuDNN input, weight)
    kinds = [("C->2C + GLU", 2 * b * n * 9 * c * 2 * c, x_nchw, weight(2 * c, c)),
             ("C->C + residual", 2 * b * n * 9 * c * c, x_nchw, weight(c, c)),
             ("upsample phases + GLU", 2 * b * n * 16 * c * c, x2,
              weight(c, c))]
    kinds = [(k, f, ops_ms(f), i, wt) for k, f, i, wt in kinds]
    if rgb:
        up = x2[:, :c // 2].contiguous(memory_format=torch.channels_last)
        head_bytes = 2 * (b * 4 * n * (c // 2) + b * 4 * n * 3)
        kinds.append(("RGB head", 2 * b * 4 * n * 9 * (c // 2) * 3,
                      head_bytes / HBM_BYTES_PER_S * 1e3, up,
                      weight(3, c // 2)))
    with torch.inference_mode():
        for name, flops, bound, inp, wt in kinds:
            ms, _ = queued_ms(lambda: F.conv2d(inp, wt, padding=1), iters=10)
            print(f"[{card}] K3 kind {name}, B={b} HW={h}x{w} C={c}: "
                  f"{flops / 1e9:.1f} GFLOP a launch, bound {bound:.4f} ms; "
                  f"cuDNN F.conv2d bf16 channels-last (yardstick, not in the "
                  f"port) {ms:.4f} ms")


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
        if name == "reschain":
            print("build reschain.cu kernels (registers, spill stores): "
                  + ", ".join(f"{k} {r} ({b} B)"
                              for k, r, b in ptxas_kernels(log)))

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
            "replaces": "t2igan/ops/pallas/reschain.py:176"}}
    check_memory_read(results)
    check_memory_read_bwd(results)
    check_reschain(results)
    drive_sampler()
    drive_fused_sampler(results)
    drive_geneval()
    drive_train_path(results)
    check_train_step_card_vs_cpu()
    time_sampler(card)
    step_ms = time_train_step(card)
    time_memory_read(card, results)
    time_memory_read_bwd(card, results, step_ms)
    time_reschain(card, results)

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
