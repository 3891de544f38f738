"""Train-mode batch normalisation with its epilogue fused in: the kernels
of ``t2igan_torch/csrc/batchnorm.cu``, their plain versions, and
:class:`BatchNormTrain`, the autograd Function that pairs them.

No TPU kernel corresponds to it: the JAX package leaves train-mode BN to
XLA (``t2igan/ops/image.py:242`` ``phase_batch_stats`` is its account of
the same statistics).  The input is viewed as ``[rows, C]``: a
channels_last map ``[B, C, H, W]`` (what the convolutions give) or the fc
BN's ``[B, F]``.  The statistics are flax's ``_compute_stats``: f32 sums
of ``x`` and ``x^2``, the biased variance ``max(0, E[x^2] - mean^2)``, and
the running statistics become ``0.9 * running + 0.1 * batch`` (ROADMAP F3:
``F.batch_norm(training=True)`` and cuDNN would write the unbiased one).
The normalised ``y = (x - mean) * weight * rstd + bias`` is f32 and goes
out in ``x``'s dtype through one of three epilogues: the GLU over the
channel halves, ``+ residual``, or none.

Four stages, each a kernel on a CUDA tensor (or a raise, never a fallback)
and a plain PyTorch version of the same arithmetic on a CPU tensor: the
statistics, the apply (with the running statistics' update), the backward
sums ``[sum(dy), sum(dy * x^)]`` (``dbias``, ``dweight``) and the backward
``dx``.  :class:`BatchNormTrain` runs the same Python on both devices;
across ranks it all-reduces the statistics between the two forward stages
and the sums between the two backward ones.

The wrappers count their launches in :data:`BN_LAUNCHES`, apart from
:data:`t2igan_torch.ops.kernels.LAUNCHES`, and each forward and backward is
a span (``t2igan.kernel.batchnorm``, ``t2igan.kernel.batchnorm_bwd``).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Tuple

import torch

from t2igan_torch.ops.kernels import build
from t2igan_torch.utils.profiling import span

BN_LAUNCHES: "collections.Counter[str]" = collections.Counter()
"""Launches of each BN kernel (``stats``, ``apply``, ``bwd_reduce``,
``bwd_dx``); reset a count by assigning 0.  A stopgap: it stands apart
from :data:`t2igan_torch.ops.kernels.LAUNCHES` only until the benchmark's
train entry expects the BN kernels' launches, and then folds into it."""

# The grid (csrc/batchnorm.cu): 256 threads a block, each on one 16-byte
# column of channels; a block covers at most 64 columns; about 264 blocks
# (two an SM of an H100) share the rows, each lane of a block taking at
# least 4 rows.  Where a chunk's last block sums the strips' partials, it
# reads at most 65536 of them, so a small input is not cut into more
# strips than that block can sum quickly.  The constants were the fastest
# of a sweep over the train cell's 15 BN shapes on the H100 (PERF.md).
THREADS = 256
MAX_COLS = 64
MAX_CHUNKS = 1024
BLOCKS = 264
MIN_ROWS_PER_LANE = 4
PARTIAL_FLOATS = 65536
EPILOGUES = {"none": 0, "glu": 1, "residual": 2}
VECTOR = {torch.bfloat16: 8, torch.float32: 4}
"""Channels in a 16-byte column, by dtype."""


def geometry(rows: int, cols: int,
             partials: int = 0) -> Tuple[int, int, int]:
    """``(columns a block, row strips, rows a strip)`` of a launch over
    ``rows`` rows of ``cols`` 16-byte columns: the grid is ``(ceil(cols /
    columns), strips)``.  ``partials``: the f32 partial sums a block writes
    for each 16-byte column of its chunk (0 where it writes none)."""
    bc = min(cols, MAX_COLS)
    lanes = THREADS // bc
    chunks = -(-cols // bc)
    strips = min(-(-BLOCKS // chunks), rows // (lanes * MIN_ROWS_PER_LANE))
    if partials:
        strips = min(strips, PARTIAL_FLOATS // (partials * bc))
    per_strip = -(-rows // max(1, strips))
    return bc, -(-rows // per_strip), per_strip


def as_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as ``[rows, C]``: a 4-D map's NHWC rows (a view where it is
    channels_last), a 2-D tensor itself."""
    if t.dim() == 4:
        return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1])
    return t


def from_rows(rows: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``rows`` [B*H*W, C'] back in ``like``'s form: a channels_last
    [B, C', H, W] map for a 4-D ``like``, else itself."""
    if like.dim() == 4:
        b, _, h, w = like.shape
        return rows.view(b, h, w, rows.shape[1]).permute(0, 3, 1, 2)
    return rows


def kernel_layout(t: torch.Tensor) -> bool:
    """Whether ``t`` is a channels_last 4-D map or a contiguous 2-D tensor
    that starts on a 16-byte boundary: the layouts the kernels take."""
    if t.dim() == 4:
        dense = t.is_contiguous(memory_format=torch.channels_last)
    else:
        dense = t.dim() == 2 and t.is_contiguous()
    return dense and t.data_ptr() % 16 == 0


def check_kernel_args(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, running_mean: torch.Tensor,
                      running_var: torch.Tensor, glu: bool = False,
                      residual: Optional[torch.Tensor] = None) -> None:
    """Raise ``ValueError`` on anything the kernels do not take: ``x``
    other than f32 or bf16, other than a channels_last [B, C, H, W] map or a
    contiguous [B, F] tensor starting on a 16-byte boundary (an
    NCHW-contiguous map or a strided view is not copied in), C not a whole
    number of 16-byte columns (of each half, with the GLU), parameters or
    running statistics other than f32 [C], or a residual unlike ``x``.
    Plain Python: it runs before any launch."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"batchnorm kernel takes f32 or bf16, not {x.dtype}")
    if x.dim() not in (2, 4) or not kernel_layout(x):
        raise ValueError(
            "batchnorm kernel takes a channels_last [B, C, H, W] map or a "
            "contiguous [B, F] tensor on a 16-byte boundary, got shape "
            f"{tuple(x.shape)} strides {x.stride()}")
    c = x.shape[1]
    step = VECTOR[x.dtype] * (2 if glu else 1)
    if c % step or x.numel() == 0 or c > step * MAX_COLS * MAX_CHUNKS:
        raise ValueError(f"batchnorm kernel takes C a multiple of {step} "
                         f"({x.dtype}{', GLU' if glu else ''}), at most "
                         f"{step * MAX_COLS * MAX_CHUNKS}, and rows; got "
                         f"shape {tuple(x.shape)}")
    for t in (weight, bias, running_mean, running_var):
        if t.dtype != torch.float32 or tuple(t.shape) != (c,):
            raise ValueError(f"batchnorm kernel takes f32 [{c}] parameters "
                             f"and running statistics, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if residual is not None and (
            residual.shape != x.shape or residual.dtype != x.dtype
            or not kernel_layout(residual)):
        raise ValueError("the residual must have x's shape, dtype and "
                         "layout")


# ---------------------------------------------------------- plain stages --

def factors(stats: torch.Tensor, weight: torch.Tensor, eps: float):
    """(mean, biased var, rstd, weight * rstd, whether the clamp let the
    variance through) per channel from the statistics [2, C]."""
    mean, msq = stats
    raw = msq - mean * mean
    var = torch.clamp(raw, min=0.0)
    rstd = torch.rsqrt(var + eps)
    return mean, var, rstd, weight.float() * rstd, raw >= 0


def forward_stats_plain(x: torch.Tensor, world: int = 1) -> torch.Tensor:
    """[mean, E[x^2]] [2, C] in f32 over the rows of ``x`` [rows, C],
    divided by ``world``."""
    xf = x.float()
    n = x.shape[0]
    return torch.stack([xf.sum(0) / n, (xf * xf).sum(0) / n]) / world


def forward_apply_plain(x, stats, weight, bias, running_mean, running_var,
                        eps: float, glu: bool, residual=None) -> torch.Tensor:
    """The normalised rows of ``x`` through the epilogue, in ``x``'s
    dtype; the running statistics updated in place."""
    mean, var, _, scale, _ = factors(stats, weight, eps)
    with torch.no_grad():
        running_mean.copy_(0.9 * running_mean + 0.1 * mean)
        running_var.copy_(0.9 * running_var + 0.1 * var)
    y = (x.float() - mean) * scale + bias.float()
    if glu:
        a, g = y.chunk(2, dim=1)
        y = a * torch.sigmoid(g)
    elif residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


def _grads_at_y(x, dout, stats, weight, bias, eps: float, glu: bool):
    """(dy, x^, weight * rstd, clamp flags): the gradient at the
    normalised y (through the GLU, recomputed from x) and x^, in f32."""
    mean, _, rstd, scale, through = factors(stats, weight, eps)
    xf = x.float()
    xhat = (xf - mean) * rstd
    dy = dout.float()
    if glu:
        a, g = ((xf - mean) * scale + bias.float()).chunk(2, dim=1)
        s = torch.sigmoid(g)
        dy = torch.cat([dy * s, dy * a * s * (1 - s)], dim=1)
    return dy, xhat, scale, through


def backward_sums_plain(x, dout, stats, weight, bias, eps: float,
                        glu: bool):
    """(sums [2, C] = [sum(dy), sum(dy x^)], dweight, dbias) over the rows,
    in f32."""
    dy, xhat, _, _ = _grads_at_y(x, dout, stats, weight, bias, eps, glu)
    sums = torch.stack([dy.sum(0), (dy * xhat).sum(0)])
    return sums, sums[1].clone(), sums[0].clone()


def backward_dx_plain(x, dout, stats, weight, bias, sums, eps: float,
                      n: int, glu: bool) -> torch.Tensor:
    """``weight rstd (dy - sums0 / n - x^ sums1 / n)`` in ``x``'s dtype, the
    x^ term dropped where the clamp held the variance at 0."""
    dy, xhat, scale, through = _grads_at_y(x, dout, stats, weight, bias,
                                           eps, glu)
    k1 = sums[0] / n
    k2 = torch.where(through, sums[1] / n, torch.zeros_like(k1))
    return (scale * (dy - k1 - xhat * k2)).to(x.dtype)


# --------------------------------------------------------------- kernels --
# On a CUDA tensor each stage launches its kernel on what
# check_kernel_args passes (BatchNormTrain checks once a forward; the
# backward's dout is laid out as x).

@functools.lru_cache(maxsize=None)
def _entry(name: str):
    fn = getattr(build.load("batchnorm"), f"t2igan_bn_{name}")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = {
        "stats": [p] * 3 + [i] * 4 + [f, f, i, p],
        "apply": [p] * 8 + [i] * 4 + [f, i, i, p],
        "bwd_reduce": [p] * 9 + [i] * 4 + [f, i, i, p],
        "bwd_dx": [p] * 7 + [i] * 4 + [f, f, i, i, p],
    }[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, x: torch.Tensor, *args) -> None:
    """Launch on ``x``'s device, on its current stream."""
    args = (*args, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    if x.device.index == torch.cuda.current_device():
        err = _entry(name)(*args)
    else:
        with torch.cuda.device(x.device):
            err = _entry(name)(*args)
    if err != 0:
        raise RuntimeError(f"batchnorm {name} kernel launch failed with CUDA "
                           f"error {err}")
    BN_LAUNCHES[name] += 1


def last_error() -> int:
    """The kernels' library's ``cudaGetLastError`` (0 when clean)."""
    fn = build.load("batchnorm").t2igan_bn_last_error
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def _on_cuda(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises on any other
    device."""
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise ValueError(f"batchnorm runs on cuda or cpu, not {x.device}")
    return False


def _grid(x: torch.Tensor, half: int,
          partials: int = 0) -> Tuple[int, int, int]:
    vec = VECTOR[x.dtype]
    return geometry(x.shape[0], half // vec, partials * vec)


def forward_stats(x: torch.Tensor, world: int = 1) -> torch.Tensor:
    """Stage 1: [mean, E[x^2]] / ``world``, f32 [2, C], of ``x`` [rows, C]."""
    if not _on_cuda(x):
        return forward_stats_plain(x, world)
    rows, c = x.shape
    bc, strips, per_strip = _grid(x, c, partials=2)
    part = torch.empty((strips, 2, c), dtype=torch.float32, device=x.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    _launch("stats", x, x.data_ptr(), part.data_ptr(), out.data_ptr(), rows,
            c, bc, per_strip, float(rows), float(world))
    return out


def forward_apply(x, stats, weight, bias, running_mean, running_var,
                  eps: float, glu: bool, residual=None) -> torch.Tensor:
    """Stage 2: the rows normalised by ``stats`` through the epilogue, in
    ``x``'s dtype ([rows, C / 2] with the GLU); the running statistics
    updated in place."""
    if not _on_cuda(x):
        return forward_apply_plain(x, stats, weight, bias, running_mean,
                                   running_var, eps, glu, residual)
    rows, c = x.shape
    half = c // 2 if glu else c
    bc, _, per_strip = _grid(x, half)
    out = torch.empty((rows, half), dtype=x.dtype, device=x.device)
    epilogue = EPILOGUES["glu" if glu else
                         "none" if residual is None else "residual"]
    _launch("apply", x, x.data_ptr(), stats.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            rows, c, bc, per_strip, eps, epilogue)
    return out


def backward_sums(x, dout, stats, weight, bias, eps: float, glu: bool):
    """Stage 3: (sums [2, C] = [sum(dy), sum(dy x^)], dweight, dbias) over
    this rank's rows, f32."""
    if not _on_cuda(x):
        return backward_sums_plain(x, dout, stats, weight, bias, eps, glu)
    rows, c = x.shape
    bc, strips, per_strip = _grid(x, c // 2 if glu else c,
                                  partials=4 if glu else 2)
    f32 = dict(dtype=torch.float32, device=x.device)
    part = torch.empty((strips, 2, c), **f32)
    sums = torch.empty((2, c), **f32)
    dweight, dbias = torch.empty(c, **f32), torch.empty(c, **f32)
    _launch("bwd_reduce", x, x.data_ptr(), dout.data_ptr(), stats.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), part.data_ptr(),
            sums.data_ptr(), dweight.data_ptr(), dbias.data_ptr(), rows, c,
            bc, per_strip, eps, int(glu))
    return sums, dweight, dbias


def backward_dx(x, dout, stats, weight, bias, sums, eps: float, n: int,
                glu: bool) -> torch.Tensor:
    """Stage 4: dx [rows, C] in ``x``'s dtype from the sums over all ``n``
    rows of the batch."""
    if not _on_cuda(x):
        return backward_dx_plain(x, dout, stats, weight, bias, sums, eps, n,
                                 glu)
    rows, c = x.shape
    bc, _, per_strip = _grid(x, c // 2 if glu else c)
    dx = torch.empty_like(x)
    _launch("bwd_dx", x, x.data_ptr(), dout.data_ptr(), stats.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), sums.data_ptr(), dx.data_ptr(),
            rows, c, bc, per_strip, eps, float(n), int(glu))
    return dx


# -------------------------------------------------------------- autograd --

class BatchNormTrain(torch.autograd.Function):
    """Train-mode BN with its epilogue:
    ``BatchNormTrain.apply(x, weight, bias, residual, running_mean,
    running_var, eps, glu, group, world)``.

    ``x`` [B, C, H, W] or [B, F]; ``glu`` halves the channels of the output;
    ``residual`` (``x``'s shape, or None) is added.  With a process
    ``group`` of ``world`` ranks, each holding ``rows`` rows, the
    statistics are those of the global batch (one all_reduce of [mean,
    E[x^2]] / world forward, one of the backward sums); ``dweight`` and
    ``dbias`` stay this rank's.  Saves ``x``, the f32 statistics and the
    parameters; no f32 copy of ``x``."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, running_mean, running_var,
                eps, glu, group, world):
        with span("t2igan.kernel.batchnorm"):
            if _on_cuda(x):
                if any(t is not None and t.device != x.device for t in
                       (weight, bias, residual, running_mean, running_var)):
                    raise ValueError("batchnorm tensors must share one "
                                     "device")
                check_kernel_args(x, weight, bias, running_mean, running_var,
                                  glu, residual)
            rows = as_rows(x)
            st = forward_stats(rows, world)
            if group is not None:
                torch.distributed.all_reduce(st, group=group)
            out = forward_apply(rows, st, weight, bias, running_mean,
                                running_var, eps, glu, None if residual is None
                                else as_rows(residual))
            ctx.save_for_backward(x, st, weight, bias)
            ctx.eps, ctx.glu, ctx.group, ctx.world = eps, glu, group, world
            ctx.residual = residual is not None
            return from_rows(out, x)

    @staticmethod
    def backward(ctx, dout):
        with span("t2igan.kernel.batchnorm_bwd"):
            x, st, weight, bias = ctx.saved_tensors
            rows = as_rows(x)
            if _on_cuda(x) and not kernel_layout(dout):
                dout = dout.clone(memory_format=torch.channels_last
                                  if dout.dim() == 4
                                  else torch.contiguous_format)
            d = as_rows(dout)
            sums, dweight, dbias = backward_sums(rows, d, st, weight, bias,
                                                 ctx.eps, ctx.glu)
            dx = None
            if ctx.needs_input_grad[0]:
                if ctx.group is not None:
                    torch.distributed.all_reduce(sums, group=ctx.group)
                dx = from_rows(backward_dx(rows, d, st, weight, bias, sums,
                                           ctx.eps, rows.shape[0] * ctx.world,
                                           ctx.glu), x)
            return (dx, dweight.to(weight.dtype), dbias.to(bias.dtype),
                    dout if ctx.residual else None,
                    None, None, None, None, None, None)


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor, eps: float,
                     glu: bool = False,
                     residual: Optional[torch.Tensor] = None,
                     group=None, world: int = 1) -> torch.Tensor:
    """Train-mode BN of ``x`` over its batch (the global one with a
    ``group``), then the GLU over the channel halves (``glu``) or ``+
    residual``; see :class:`BatchNormTrain`."""
    if glu and residual is not None:
        raise ValueError("batch_norm_train takes the GLU or a residual, not "
                         "both")
    return BatchNormTrain.apply(x, weight, bias, residual, running_mean,
                                running_var, eps, glu, group, world)
