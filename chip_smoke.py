#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card.  It imports
``t2igan_torch`` (never JAX or the ``t2igan`` package) and:

1. prints the card's name and power limit, builds every CUDA kernel of the
   path with ``nvcc`` and prints the build time;
2. holds each kernel to its plain PyTorch version on the card, at the main
   path's shapes and at the edges of what the kernel takes, f32 and bf16,
   masked and unmasked, with ragged pixel counts, and prints the error
   beside its stated tolerance;
3. drives the main path: ``t2igan_torch.generate.generate`` at the widths of
   ``t2igan_torch/configs/eval_clip_bird.yml`` (full ViT-B/32 text tower,
   weights from a seed) on caption requests at the YAML's batch of 10, and
   checks the images and that each sampler call launched the memory-read
   kernel exactly twice; then holds the f32 sampler on the card to the same
   sampler on the CPU and prints the bf16-vs-f32 gap;
4. times the sampler at batch 128 in bf16 and each kernel beside its plain
   version, one PyTorch library call and its bound, with CUDA events.

It ends with a ``{"kernels": [...]}`` line, the card line and, last,
``{"ok": true, "device": {...}}``.  Any failure raises, and the process
exits non-zero; without a CUDA card it exits 1 and prints no result.
"""

from __future__ import annotations

import json
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

# memory read: batch of the timed sampler, and its two refinement stages.
TIMED_BATCH = 128
STAGE_HW = ((64, 64), (128, 128))
SLOTS, CHANNELS = 77, 64


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
    # (batch, HW, C, L): the main path's shapes at batch 16, then the edges
    # of what the kernel takes (L = 1 and 128, C = 4 and 128, odd HW).
    cases = [(16, hw, CHANNELS, SLOTS) for hw in STAGE_HW + ((17, 19),)]
    cases += [(3, (5, 7), 4, 1), (2, (33, 9), 36, 33), (2, (16, 16), 128, 128)]
    worst = 0.0
    seed = 0
    for dtype in (torch.float32, torch.bfloat16):
        for b, hw, c, slots in cases:
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


def drive_main_path(results):
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

    LAUNCHES["memory_read_fwd"] = 0
    t0 = time.perf_counter()
    images = generate(cfg, captions, out_dir, batch, torch.bfloat16, seed=0,
                      device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = LAUNCHES["memory_read_fwd"]
    results["memory_read_fwd"]["launches"] = launches
    print(f"main path: generate {len(captions)} captions, batch {batch}, bf16"
          f", {calls} sampler calls, {seconds:.2f} s with model set-up; "
          f"memory_read_fwd launches {launches}")
    if launches != 2 * calls:
        raise AssertionError(f"expected 2 memory_read_fwd launches per "
                             f"sampler call, got {launches} in {calls} calls")
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


def time_sampler(card):
    """Phase 4a: sampler ms/batch at batch 128 in bf16, the JAX bench's
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
    """Phase 4b: K1 against memory_read_plain and SDPA at each stage shape
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
    seconds = build.build(["memory_read"])
    print(f"build memory_read.cu with nvcc: {seconds['memory_read']:.1f} s "
          f"-> {build.library_path('memory_read').name}")
    log = build.library_path("memory_read").with_suffix(".so.log")
    if log.exists():
        regs = [line.split("Used")[1].strip() for line in
                log.read_text().splitlines() if "Used" in line]
        print(f"ptxas: {len(regs)} kernels; e.g. {regs[:2]}")

    results = {"memory_read_fwd": {
        "name": "memory_read_fwd", "route": "cuda",
        "source": "t2igan_torch/csrc/memory_read.cu",
        "replaces": "t2igan/ops/pallas/memory_read.py:41"}}
    check_memory_read(results)
    drive_main_path(results)
    time_sampler(card)
    time_memory_read(card, results)

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
