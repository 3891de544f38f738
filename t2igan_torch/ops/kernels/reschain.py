"""The fused eval stage tail (K3): R residual blocks, the 2x upsample conv
with GLU and, optionally, the RGB head, on folded eval-mode weights.

Port of ``t2igan/ops/pallas/reschain.py::resblock_chain_up_fused`` at its
NHWC signature, without ``row_chunk`` and ``interpret``.  On a CUDA tensor
:func:`resblock_chain_up_fused` launches the hand-written kernels of
``t2igan_torch/csrc/reschain.cu`` or raises; on a CPU tensor it runs
:func:`resblock_chain_up_plain`.  Neither falls back.

Weights arrive as the JAX package folds them: conv kernels HWIO
([3, 3, Cin, Cout]) in the activation dtype, each eval BatchNorm as an f32
per-channel ``(scale, shift)``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from t2igan_torch.ops.kernels import LAUNCHES, build

KERNEL = "reschain"
CHANNEL_MULTIPLE = 16  # the kernel's channel tiling (16-deep products)

# Tap sets of the subpixel decomposition of conv3x3-over-nearest-2x (a copy
# of the JAX package's ``_PHASE_TAPS``): output row 2i+a reads low-res rows
# i-1+a+p for p in {0, 1}, with weights [K0, K1+K2] for a = 0 and
# [K0+K1, K2] for a = 1; the same for columns.
PHASE_TAPS = (((0,), (1, 2)), ((0, 1), (2,)))

RbParams = Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                 torch.Tensor, torch.Tensor, torch.Tensor]


def phase_kernels(kernel: torch.Tensor) -> torch.Tensor:
    """[3, 3, C, F] conv kernel -> [4 (phase 2a+b), 2, 2, C, F] summed-tap
    kernels of the four subpixel phases (``_phase_kernels``)."""
    out = []
    for a in (0, 1):
        for b in (0, 1):
            rows = []
            for us in PHASE_TAPS[a]:
                rows.append(torch.stack([
                    sum(kernel[u, v] for u in us for v in vs)
                    for vs in PHASE_TAPS[b]]))
            out.append(torch.stack(rows))
    return torch.stack(out)


def _conv3x3(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Zero-padded 3x3 conv of an NCHW map by an HWIO kernel, in x's
    dtype."""
    return F.conv2d(x, kernel.to(x.dtype).permute(3, 2, 0, 1), padding=1)


def _affine(y: torch.Tensor, scale: torch.Tensor,
            shift: torch.Tensor) -> torch.Tensor:
    return (y.float() * scale.float().view(1, -1, 1, 1)
            + shift.float().view(1, -1, 1, 1))


def resblock_chain_up_plain(x: torch.Tensor, rb_params: Sequence[RbParams],
                            up_kernel: torch.Tensor, up_scale: torch.Tensor,
                            up_shift: torch.Tensor,
                            rgb_kernel: Optional[torch.Tensor] = None,
                            want_h: bool = True):
    """The tail in plain PyTorch (``resblock_chain_up_reference``): each
    conv in x's dtype with zero padding, its output taken to f32 for the
    affine; rounded to x's dtype after each GLU, each residual sum, the
    upsample GLU and the tanh.

    x: [B, H, W, C].  Returns ``up`` [B, 2H, 2W, C/2], ``(up, rgb)`` or
    ``rgb`` [B, 2H, 2W, 3] by ``want_h`` and ``rgb_kernel``.
    """
    if not want_h and rgb_kernel is None:
        raise ValueError("nothing to compute: want_h=False and no rgb head")
    dtype = x.dtype
    h = x.permute(0, 3, 1, 2)
    for (k1, s1, b1, k2, s2, b2) in rb_params:
        y = F.glu(_affine(_conv3x3(h, k1), s1, b1), dim=1).to(dtype)
        z = _affine(_conv3x3(y, k2), s2, b2)
        h = (h.float() + z).to(dtype)
    up = F.interpolate(h, scale_factor=2, mode="nearest")
    up = F.glu(_affine(_conv3x3(up, up_kernel), up_scale, up_shift),
               dim=1).to(dtype)
    up_nhwc = up.permute(0, 2, 3, 1)
    if rgb_kernel is None:
        return up_nhwc
    rgb = torch.tanh(_conv3x3(up, rgb_kernel).float()).to(dtype)
    rgb = rgb.permute(0, 2, 3, 1)
    return (up_nhwc, rgb) if want_h else rgb


def check_kernel_args(x: torch.Tensor, rb_params: Sequence[RbParams],
                      up_kernel: torch.Tensor, up_scale: torch.Tensor,
                      up_shift: torch.Tensor,
                      rgb_kernel: Optional[torch.Tensor],
                      want_h: bool) -> None:
    """Raise ``ValueError`` on anything the kernel does not take: x not a
    contiguous f32/bf16 [B, H, W, C] with C a positive multiple of 16, no
    residual block, a weight of another shape or device, a nothing-to-do
    call."""
    if not want_h and rgb_kernel is None:
        raise ValueError("nothing to compute: want_h=False and no rgb head")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"reschain kernel takes f32 or bf16, not {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("reschain kernel takes a contiguous NHWC x (an NCHW "
                         "map in channels_last memory, permuted)")
    b, h, w, c = x.shape
    if c < CHANNEL_MULTIPLE or c % CHANNEL_MULTIPLE:
        raise ValueError(f"reschain kernel takes C a multiple of "
                         f"{CHANNEL_MULTIPLE}, got {c}")
    if min(b, h, w) < 1 or b * 4 * h * w >= 2 ** 31:
        raise ValueError(f"reschain kernel takes 1 <= B*4*H*W < 2^31, got "
                         f"{tuple(x.shape)}")
    if len(rb_params) < 1:
        raise ValueError("reschain kernel takes at least one residual block")
    shapes = []
    for (k1, s1, b1, k2, s2, b2) in rb_params:
        shapes += [(k1, (3, 3, c, 2 * c)), (s1, (2 * c,)), (b1, (2 * c,)),
                   (k2, (3, 3, c, c)), (s2, (c,)), (b2, (c,))]
    shapes += [(up_kernel, (3, 3, c, c)), (up_scale, (c,)), (up_shift, (c,))]
    if rgb_kernel is not None:
        shapes.append((rgb_kernel, (3, 3, c // 2, 3)))
    for t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"reschain weight of shape {tuple(t.shape)} "
                             f"where {shape} is expected")
        if t.device != x.device:
            raise ValueError("reschain tensors must share one device")


def _gemm_weight(kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[..., taps_h, taps_w, Cin, Cout] -> [..., Cout, taps*Cin] in
    ``dtype``: each output channel's taps and input channels contiguous,
    the kernel's B-operand layout."""
    lead = kernel.shape[:-4]
    th, tw, cin, cout = kernel.shape[-4:]
    k = kernel.to(dtype).movedim(-1, -4)
    return k.reshape(*lead, cout, th * tw * cin).contiguous()


def _affine_pair(scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    return torch.stack([scale, shift]).float().contiguous()


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load(KERNEL).t2igan_reschain
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 4        # per-block pointer arrays
                   + [ctypes.c_void_p] * 3        # up weight, up affine, rgb
                   + [ctypes.c_void_p] * 4        # up out, rgb out, 2 scratch
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def resblock_chain_up_fused(x: torch.Tensor, rb_params: Sequence[RbParams],
                            up_kernel: torch.Tensor, up_scale: torch.Tensor,
                            up_shift: torch.Tensor,
                            rgb_kernel: Optional[torch.Tensor] = None,
                            want_h: bool = True):
    """Fused eval tail of a refinement stage.

    x: [B, H, W, C] post-gate features; ``rb_params``: per ResBlock
    ``(k1 [3,3,C,2C], scale1 [2C], shift1 [2C], k2 [3,3,C,C], scale2 [C],
    shift2 [C])``; ``up_kernel`` [3,3,C,C] with ``up_scale``/``up_shift``
    [C]; ``rgb_kernel`` [3,3,C/2,3] or None.  Returns ``up``
    [B, 2H, 2W, C/2], ``(up, rgb)`` or ``rgb`` [B, 2H, 2W, 3] in x's dtype,
    as :func:`resblock_chain_up_plain`.

    On a CUDA tensor this launches the kernels of ``csrc/reschain.cu``
    (one C call, 2R + 1 or 2R + 2 device kernels, counted once in
    ``LAUNCHES["reschain"]``) and raises on anything they do not take; on
    a CPU tensor it runs :func:`resblock_chain_up_plain`.
    """
    if x.device.type == "cpu":
        return resblock_chain_up_plain(x, rb_params, up_kernel, up_scale,
                                       up_shift, rgb_kernel, want_h)
    if x.device.type != "cuda":
        raise ValueError(f"reschain runs on cuda or cpu, not {x.device}")
    check_kernel_args(x, rb_params, up_kernel, up_scale, up_shift,
                      rgb_kernel, want_h)
    dtype = x.dtype
    b, h, w, c = x.shape
    n_res = len(rb_params)
    # The B operands, laid out once per call (they are small: 0.3 MB per
    # conv at C = 128 in bf16); kept alive until the launches are queued.
    w1 = [_gemm_weight(p[0], dtype) for p in rb_params]
    a1 = [_affine_pair(p[1], p[2]) for p in rb_params]
    w2 = [_gemm_weight(p[3], dtype) for p in rb_params]
    a2 = [_affine_pair(p[4], p[5]) for p in rb_params]
    w_up = _gemm_weight(phase_kernels(up_kernel.float()), dtype)
    a_up = _affine_pair(up_scale, up_shift)
    w_rgb = None if rgb_kernel is None else _gemm_weight(rgb_kernel, dtype)

    def ptrs(ts):
        return (ctypes.c_void_p * n_res)(*[t.data_ptr() for t in ts])

    fn = _entry()
    with torch.cuda.device(x.device):
        up = torch.empty((b, 2 * h, 2 * w, c // 2), dtype=dtype,
                         device=x.device)
        rgb = (None if w_rgb is None else
               torch.empty((b, 2 * h, 2 * w, 3), dtype=dtype, device=x.device))
        scratch = torch.empty((2, b, h, w, c), dtype=dtype, device=x.device)
        err = fn(x.data_ptr(), n_res, ptrs(w1), ptrs(a1), ptrs(w2), ptrs(a2),
                 w_up.data_ptr(), a_up.data_ptr(),
                 None if w_rgb is None else w_rgb.data_ptr(),
                 up.data_ptr(), None if rgb is None else rgb.data_ptr(),
                 scratch[0].data_ptr(), scratch[1].data_ptr(),
                 b, h, w, c, int(dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"reschain kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[KERNEL] += 1
    if rgb is None:
        return up
    return (up, rgb) if want_h else rgb
