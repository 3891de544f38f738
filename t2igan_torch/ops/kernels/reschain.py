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
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from t2igan_torch.ops.kernels import LAUNCHES, build
from t2igan_torch.utils.profiling import span

KERNEL = "reschain"
CHANNEL_MULTIPLE = 16  # the kernel's channel tiling (16-deep products)

# Tiles of the kernels (tile_geometry), the same in bf16 and f32: a conv
# tile is a patch of one image, TILE_PIXELS[mode] output pixels (the wgmma
# row blocks of its two consumer warpgroups: one each for the N = 2C convs,
# two for N = C), its width one of PATCH_COLS; a head tile is an 8 x 32
# patch read with its halo.  TMA boxes are BOX_CHANNELS[dtype][mode] deep:
# in bf16 64 (128 bytes, the 128-byte swizzle) or 32 (64 bytes, the 64-byte
# swizzle); in f32 16 (64 bytes, the 64-byte swizzle), the K slice of the
# TF32 products.
TILE_PIXELS = {"glu": 128, "residual": 256, "up": 256}
CONV_MODES = tuple(TILE_PIXELS)
# The affine rows are zero-padded to a multiple of AFFINE_PAD columns (a
# multiple of every conv tile's N), so the epilogue runs without a branch
# on the columns.
AFFINE_PAD = 256
PATCH_COLS = (128, 64, 32, 16, 8)
HEAD_TILE = (8, 32)
BOX_CHANNELS = {
    torch.bfloat16: {"glu": 64, "residual": 32, "up": 64, "head": 64},
    torch.float32: {"glu": 16, "residual": 16, "up": 16, "head": 16},
}
# The f32 convs' order of each 16 input channels along K (the 4 x 4
# transpose): a thread of the kernel reads channels 4t .. 4t + 3 of a
# pixel at once and gives them to k = t, t + 4 of two k8 steps, so K
# position 8s + k of a slice holds channel 4 (k % 4) + 2s + k // 4.
F32_K_ORDER = tuple(4 * (p % 4) + p // 4 for p in range(16))

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


F32_UNIT = 2.0 ** -24  # unit roundoff of f32


def f32_tol(c: int, scale: float) -> float:
    """How far the f32 kernels may stand from
    :func:`resblock_chain_up_plain` in f32: the worst-case f32 rounding of
    a 9C-term sum, about five convs deep, times ``scale`` (the largest
    output magnitude), plus 1e-6."""
    return 5 * 9 * c * F32_UNIT * scale + 1e-6


def f32_f64_tol(plain_err: float, c: int, scale: float) -> float:
    """The stricter f32 check, against the tail in float64: no farther from
    it than twice the plain f32 version (``plain_err``) plus
    min(12 C 2^-24, 2^-13) of ``scale``.

    The kernels' 3xTF32 products are as good as f32's, but the tensor
    cores add to an f32 accumulator rounding toward zero, three times a k8
    step, so the chain stands a few C 2^-24 of its scale from float64
    where plain f32 stands ~1e-6: on an H100 at most 7.7 C 2^-24 past
    twice the plain error over every case of the card's check (the RGB
    head at R = 3, C = 128; 2.3 at C = 256).  A fault (one TF32 product,
    or the lo part of either operand left out) errs by ~2^-12 of each
    term's size, which does not shrink with C: the CPU emulation of the
    kernels puts it at 2.4e-4 of the scale or more at 16 x 16 (35 C 2^-24
    at C = 128, 16 at C = 256), so the 2^-13 cap (1.2e-4, from C = 168 up)
    keeps the limit at half of it where 12 C 2^-24 alone would reach it
    by C ~ 330.  The kernels' fast GLU sigmoid errs by at most ~5 2^-24 of
    the value (the emulation takes it at that worst case), under this
    limit's resolution.  :func:`f32_tol` (45 C 2^-24) lets such faults
    through at C = 128 where no RGB head follows."""
    return 2 * plain_err + min(12 * c * F32_UNIT, 2.0 ** -13) * scale


class TileGeometry(NamedTuple):
    """How a kernel of K3 cuts its output into tiles: a patch of
    ``rows`` x ``cols`` pixels of one image, ``tiles_y`` x ``tiles_x``
    patches an image, and the TMA box of its input tile, innermost first
    (channels, columns, rows, images)."""

    rows: int
    cols: int
    tiles_y: int
    tiles_x: int
    box: Tuple[int, int, int, int]


def tile_geometry(h: int, w: int, mode: str,
                  dtype: torch.dtype) -> TileGeometry:
    """Tiles of the kernels of ``dtype`` over an [h, w] grid.

    ``mode`` "glu", "residual" or "up" (the convs; for "up", [h, w] is the
    low-res input grid and each tile is one subpixel phase of its
    pixels): a patch of ``TILE_PIXELS[mode]`` pixels, the wgmma tile's M,
    ``cols`` one of :data:`PATCH_COLS` and ``rows`` the rest, the one that
    needs the fewest patches (the wider on a tie); the box is that patch.
    ``mode`` "head" (the RGB head over the 2x grid): the head kernel's
    fixed 8 x 32 patch and a box with its one-pixel halo.  Boxes are
    ``BOX_CHANNELS[dtype][mode]`` deep; every box dimension is at most
    256, and the inner one spans the row of its swizzle (64 or 128
    bytes)."""
    if h < 1 or w < 1:
        raise ValueError(f"tile_geometry takes h, w >= 1, got {h}, {w}")
    if dtype not in BOX_CHANNELS:
        raise ValueError(f"tile_geometry takes f32 or bf16, not {dtype}")
    depth = BOX_CHANNELS[dtype]
    if mode == "head":
        rows, cols = HEAD_TILE
        return TileGeometry(rows, cols, -(-h // rows), -(-w // cols),
                            (depth[mode], cols + 2, rows + 2, 1))
    if mode not in CONV_MODES:
        raise ValueError(f"unknown tile mode {mode!r}; expected one of "
                         f"{CONV_MODES + ('head',)}")

    pixels = TILE_PIXELS[mode]

    def tiles(cols):
        return -(-h // (pixels // cols)), -(-w // cols)

    cols = min(PATCH_COLS, key=lambda c: (tiles(c)[0] * tiles(c)[1], -c))
    rows = pixels // cols
    return TileGeometry(rows, cols, *tiles(cols),
                        (depth[mode], cols, rows, 1))


def check_kernel_args(x: torch.Tensor, rb_params: Sequence[RbParams],
                      up_kernel: torch.Tensor, up_scale: torch.Tensor,
                      up_shift: torch.Tensor,
                      rgb_kernel: Optional[torch.Tensor],
                      want_h: bool) -> None:
    """Raise ``ValueError`` on anything the kernel does not take: x not a
    contiguous f32/bf16 [B, H, W, C] with C a positive multiple of 16, an
    x that TMA cannot read (not on a 16-byte boundary, or a pixel's
    channels not a multiple of 16 bytes), no residual block, a weight of
    another shape or device, a nothing-to-do call."""
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
    # TMA reads the maps in both dtypes: a base on a 16-byte boundary, and
    # rows (a pixel's channels, C of x and C/2 of the upsampled map) of
    # whole 16-byte units.
    name = "bf16" if x.dtype == torch.bfloat16 else "f32"
    if x.data_ptr() % 16:
        raise ValueError(f"{name} x must start on a 16-byte boundary")
    if (c * x.element_size()) % 16 or (c // 2 * x.element_size()) % 16:
        raise ValueError(f"{name} rows of C = {c} and C/2 channels must be "
                         f"multiples of 16 bytes")
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


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 mantissa bits), ties away from zero,
    as ``cvt.rna.tf32.f32`` and the kernels' ``mr::tf32_rna`` round a
    finite value: half a TF32 step added to the magnitude bits, the low 13
    bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> torch.Tensor:
    """[2, *x.shape]: ``hi = tf32_rna(x)`` and ``lo = tf32_rna(x - hi)``,
    both TF32, ``hi + lo`` within 2^-22 |x| of x."""
    hi = tf32_rna(x)
    return torch.stack([hi, tf32_rna(x.float() - hi)])


def glu_column_order(n: int, device=None) -> torch.Tensor:
    """The kernels' GEMM column order of a GLU conv with ``n`` output
    columns (values ``[0, n/2)``, gates ``[n/2, n)``): GEMM column ``16q + i``
    is value channel ``8q + i`` for ``i < 8`` and the gate of channel
    ``8q + i - 8`` otherwise, so the wgmma accumulator thread that holds a
    channel's value also holds its gate.  Entry j is the source column of
    GEMM column j (on ``device``: made there, so laying out the weights
    never waits for the card)."""
    if n % 16:
        raise ValueError(f"GLU columns come in groups of 16, got {n}")
    j = torch.arange(n, device=device)
    group, i = j // 16, j % 16
    return torch.where(i < 8, 8 * group + i, n // 2 + 8 * group + i - 8)


class TailOperands(NamedTuple):
    """K3's operands laid out for the kernels of one dtype: the folded
    weights as given (``folded``, what the plain version takes) and the
    GEMM-ordered copies that the C entry reads.  In both dtypes the GLU
    convs' columns come in :func:`glu_column_order` (``w1``/``a1``, and
    ``w_up``/``a_up`` per subpixel phase) and the affine rows (f32 in both)
    are zero-padded to a multiple of :data:`AFFINE_PAD` columns.  bf16
    weights are [Cout, taps*Cin] per conv (``w_up`` [4, ...], one per
    phase); f32 ones have a parts axis before Cout, the TF32 ``hi`` and
    ``lo`` of :func:`split_tf32` (``hi + lo`` is the f32 weight to
    2^-22), and each 16 input channels of a conv (not of the head,
    ``w_rgb``) in :data:`F32_K_ORDER`."""

    folded: tuple
    dtype: torch.dtype
    w1: Tuple[torch.Tensor, ...]
    a1: Tuple[torch.Tensor, ...]
    w2: Tuple[torch.Tensor, ...]
    a2: Tuple[torch.Tensor, ...]
    w_up: torch.Tensor
    a_up: torch.Tensor
    w_rgb: Optional[torch.Tensor]


def lay_out_operands(rb_params: Sequence[RbParams], up_kernel: torch.Tensor,
                     up_scale: torch.Tensor, up_shift: torch.Tensor,
                     rgb_kernel: Optional[torch.Tensor],
                     dtype: torch.dtype) -> TailOperands:
    """Lay out the folded weights for the kernels of ``dtype`` (on their
    own device).  Worth keeping while the weights do not change: it is
    ~50 small tensor ops a stage.  Under a profiler each layout is the
    span ``t2igan.kernel.layout``: none in a trace of calls whose operands
    were kept."""
    with span("t2igan.kernel.layout"):
        if dtype not in BOX_CHANNELS:
            raise ValueError(f"reschain operands are f32 or bf16, not "
                             f"{dtype}")
        f32 = dtype == torch.float32

        def affine(scale, shift, order=None):
            a = _affine_pair(scale, shift)
            if order is not None:
                a = a.index_select(-1, order)
            return F.pad(a, (0, -a.shape[-1] % AFFINE_PAD)).contiguous()

        def parts(w, conv=True):
            """f32: [..., N, K] -> [..., 2 (hi, lo), N, K], a conv's input
            channels in F32_K_ORDER; bf16: w."""
            if not f32:
                return w.contiguous()
            if conv:
                # made on w's device, as glu_column_order is
                j = torch.arange(16, device=w.device)
                order = 4 * (j % 4) + j // 4
                w = w.unflatten(-1, (-1, 16)).index_select(-1, order)
                w = w.flatten(-2)
            return split_tf32(w).movedim(0, -3).contiguous()

        def conv(kernel, scale=None, shift=None):
            w = _gemm_weight(kernel, dtype)
            if scale is None:
                return parts(w), None
            order = glu_column_order(w.shape[-2], w.device)
            return (parts(w.index_select(-2, order)),
                    affine(scale, shift, order))

        first = [conv(p[0], p[1], p[2]) for p in rb_params]
        w_up, a_up = conv(phase_kernels(up_kernel.float()), up_scale,
                          up_shift)
        return TailOperands(
            folded=(tuple(rb_params), up_kernel, up_scale, up_shift,
                    rgb_kernel),
            dtype=dtype, w1=tuple(w for w, _ in first),
            a1=tuple(a for _, a in first),
            w2=tuple(conv(p[3])[0] for p in rb_params),
            a2=tuple(affine(p[4], p[5]) for p in rb_params),
            w_up=w_up, a_up=a_up,
            w_rgb=None if rgb_kernel is None else
            parts(_gemm_weight(rgb_kernel, dtype), conv=False))


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load(KERNEL).t2igan_reschain
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 4        # per-block pointer arrays
                   + [ctypes.c_void_p] * 3        # up weight, up affine, rgb
                   + [ctypes.c_void_p] * 4        # up out, rgb out, 2 scratch
                   + [ctypes.c_int] * 5           # B, H, W, C, is_bf16
                   + [ctypes.c_void_p] * 2)       # geometry, stream
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

    On a CUDA tensor this lays the weights out (:func:`lay_out_operands`)
    and launches the kernels of ``csrc/reschain.cu`` (one C call, 2R + 1 or
    2R + 2 device kernels, counted once in ``LAUNCHES["reschain"]``), and
    raises on anything they do not take; on a CPU tensor it runs
    :func:`resblock_chain_up_plain`.  A caller that keeps the laid-out
    weights calls :func:`fused_tail` instead.
    """
    if x.device.type == "cpu":
        return resblock_chain_up_plain(x, rb_params, up_kernel, up_scale,
                                       up_shift, rgb_kernel, want_h)
    if x.device.type != "cuda":
        raise ValueError(f"reschain runs on cuda or cpu, not {x.device}")
    check_kernel_args(x, rb_params, up_kernel, up_scale, up_shift,
                      rgb_kernel, want_h)
    return fused_tail(x, lay_out_operands(rb_params, up_kernel, up_scale,
                                          up_shift, rgb_kernel, x.dtype),
                      want_h)


def fused_tail(x: torch.Tensor, ops: TailOperands, want_h: bool = True):
    """:func:`resblock_chain_up_fused` on operands laid out beforehand
    (:func:`lay_out_operands`, in x's dtype): the plain version on
    ``ops.folded`` for a CPU x; the kernels on a CUDA x.  Under a profiler
    each call is the span ``t2igan.kernel.reschain``, whose host interval
    holds the launches of the call's 2R + 1 or 2R + 2 kernels."""
    with span("t2igan.kernel.reschain"):
        if x.device.type == "cpu":
            return resblock_chain_up_plain(x, *ops.folded, want_h)
        if x.device.type != "cuda":
            raise ValueError(f"reschain runs on cuda or cpu, not {x.device}")
        if ops.dtype != x.dtype:
            raise ValueError(f"operands laid out for {ops.dtype}, x is "
                             f"{x.dtype}")
        check_kernel_args(x, *ops.folded, want_h)
        dtype = x.dtype
        b, h, w, c = x.shape
        n_res = len(ops.w1)
        geometry = []
        for mode in CONV_MODES + ("head",):
            geo = tile_geometry(
                *((2 * h, 2 * w) if mode == "head" else (h, w)), mode, dtype)
            geometry += [*geo[:4], geo.box[0]]
        geometry = (ctypes.c_int * len(geometry))(*geometry)

        def ptrs(ts):
            return (ctypes.c_void_p * n_res)(*[t.data_ptr() for t in ts])

        fn = _entry()
        with torch.cuda.device(x.device):
            up = torch.empty((b, 2 * h, 2 * w, c // 2), dtype=dtype,
                             device=x.device)
            rgb = (None if ops.w_rgb is None else
                   torch.empty((b, 2 * h, 2 * w, 3), dtype=dtype,
                               device=x.device))
            scratch = torch.empty((2, b, h, w, c), dtype=dtype,
                                  device=x.device)
            err = fn(x.data_ptr(), n_res, ptrs(ops.w1), ptrs(ops.a1),
                     ptrs(ops.w2), ptrs(ops.a2),
                     ops.w_up.data_ptr(), ops.a_up.data_ptr(),
                     None if ops.w_rgb is None else ops.w_rgb.data_ptr(),
                     up.data_ptr(), None if rgb is None else rgb.data_ptr(),
                     scratch[0].data_ptr(), scratch[1].data_ptr(),
                     b, h, w, c, int(dtype == torch.bfloat16), geometry,
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"reschain kernel launch failed with CUDA "
                               f"error {err}")
        LAUNCHES[KERNEL] += 1
        if rgb is None:
            return up
        return (up, rgb) if want_h else rgb
