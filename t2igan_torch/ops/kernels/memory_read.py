"""DM-GAN memory read: the K1 (forward) and K2 (backward) kernels, their
plain versions, the bounds on their bf16 rounding, and
:class:`MemoryRead`, the autograd pairing of the two.

Port of ``t2igan/ops/pallas/memory_read.py::memory_read_fused`` and its
``custom_vjp``.  On a CUDA tensor :func:`memory_read_fused` launches the
hand-written kernel in ``t2igan_torch/csrc/memory_read.cu`` and
:func:`memory_read_bwd` the one in ``csrc/memory_read_bwd.cu``, or they
raise; on a CPU tensor they run :func:`memory_read_plain` and
:func:`memory_read_bwd_plain`.  Neither falls back.  Both dtypes run on
the tensor cores.  In bf16 the kernels round the attention (and the
backward's ds) to bf16 before the products that take it; in f32 every
product is 3xTF32 (each operand split into two TF32 parts, three
products summed in f32), and nothing is rounded below f32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from t2igan_torch.ops.kernels import LAUNCHES, build

NEG_INF = -1e9  # padding fill, as in the JAX package
MAX_SLOTS = 128
MAX_CHANNELS = 128
KERNEL = "memory_read_fwd"
BWD_KERNEL = "memory_read_bwd"
# The wrappers pick the pixels per block (a multiple of the kernel's step,
# at most a cap) so that about a target number of blocks share the work:
# two per SM of an H100 (264) for the bf16 forward; one per SM (132) for
# the others, of which one block fills an SM (the bf16 backward: over 128
# registers a thread, 139 KB of shared memory; the f32 kernels: 221 KB
# forward, 216 KB backward at L = 77, C = 64).  The steps: 128 pixels (8
# warps of 16 rows), 256 for the f32 forward (16 warps where L + C is
# small).  The caps and targets were the fastest of the pixel runs timed
# on the H100 (PERF.md).
TC_STEP = 128
F32_FWD_STEP = 256
BF16_FWD_MAX_TILE = 1024
BF16_FWD_BLOCKS = 264
MAX_TILE = 4096
SM_BLOCKS = 132
# Unit roundoffs: a bf16 or f32 rounding moves a value by at most this
# times its magnitude.
BF16_UNIT = 2.0 ** -8
F32_UNIT = 2.0 ** -24


def memory_read_plain(query_map: torch.Tensor, key: torch.Tensor,
                      value: torch.Tensor,
                      pad_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Einsum form of the read: f32 logits, -1e9 at padding slots, f32
    softmax and f32 read-out, returned in ``query_map``'s dtype.

    query_map: [B, H, W, C]; key/value: [B, L, C]; pad_mask: [B, L] bool,
    True at padding, or None.  A fully padded row attends uniformly.
    """
    b, h, w, c = query_map.shape
    q = query_map.reshape(b, h * w, c).float()
    logits = torch.einsum("bqc,blc->bql", q, key.float())
    if pad_mask is not None:
        logits = logits.masked_fill(pad_mask[:, None, :], NEG_INF)
    attn = torch.softmax(logits, dim=-1)
    read = torch.einsum("bql,blc->bqc", attn, value.float())
    return read.reshape(b, h, w, c).to(query_map.dtype)


def memory_read_bwd_plain(query_map: torch.Tensor, key: torch.Tensor,
                          value: torch.Tensor,
                          pad_mask: Optional[torch.Tensor],
                          dout: torch.Tensor):
    """The read's gradients, step by step as the TPU backward kernel takes
    them, in f32: recompute the attention (-1e9 at padding, softmax), then
    ``dattn = dout v^T``, ``ds = attn * (dattn - rowsum(attn * dattn))``,
    ``dq = ds k``, ``dk = ds^T q``, ``dv = attn^T dout``.

    ``ds`` is zero at padding slots: that is the gradient of the -1e9
    fill, and it differs from the TPU kernel only on a fully padded row,
    where the logits do not depend on q or k at all.  Returns (dq, dk, dv)
    in the dtypes of (query_map, key, value).
    """
    b, h, w, c = query_map.shape
    q = query_map.reshape(b, h * w, c).float()
    k, v = key.float(), value.float()
    g = dout.reshape(b, h * w, c).float()
    logits = torch.einsum("bqc,blc->bql", q, k)
    if pad_mask is not None:
        logits = logits.masked_fill(pad_mask[:, None, :], NEG_INF)
    attn = torch.softmax(logits, dim=-1)
    dattn = torch.einsum("bqc,blc->bql", g, v)
    ds = attn * (dattn - torch.sum(attn * dattn, dim=-1, keepdim=True))
    if pad_mask is not None:
        ds = ds.masked_fill(pad_mask[:, None, :], 0.0)
    dq = torch.einsum("bql,blc->bqc", ds, k)
    dk = torch.einsum("bql,bqc->blc", ds, q)
    dv = torch.einsum("bql,bqc->blc", attn, g)
    return (dq.reshape(b, h, w, c).to(query_map.dtype), dk.to(key.dtype),
            dv.to(value.dtype))


def _attention_f64(query_map, key, pad_mask):
    """q [B, HW, C], the attention [B, HW, L] and the largest
    sum_c |q_c k_c| of any logit, in float64."""
    b, h, w, c = query_map.shape
    q = query_map.reshape(b, h * w, c).double()
    k = key.double()
    logits = torch.einsum("bqc,blc->bql", q, k)
    if pad_mask is not None:
        logits = logits.masked_fill(pad_mask[:, None, :], NEG_INF)
    s_abs = torch.einsum("bqc,blc->bql", q.abs(), k.abs()).max().item()
    return q, logits.softmax(-1), s_abs


def read_f64(query_map: torch.Tensor, key: torch.Tensor,
             value: torch.Tensor,
             pad_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The exact read [B, H, W, C] in float64 (-1e9 at padding slots)."""
    _, attn, _ = _attention_f64(query_map, key, pad_mask)
    return torch.einsum("bql,blc->bqc", attn,
                        value.double()).reshape(query_map.shape)


def fwd_bf16_bound(query_map: torch.Tensor, key: torch.Tensor,
                   value: torch.Tensor, pad_mask: Optional[torch.Tensor],
                   against_plain: bool = False) -> float:
    """How far K1 in bf16 may be from the exact read (``against_plain``
    False) or from :func:`memory_read_plain` (True), as one bound on the
    largest absolute error, computed in float64 from the inputs.

    K1 rounds the attention p to bf16 before ``p . v`` (as the TPU kernel
    does) and the output to bf16.  With ``A = max sum_s p_s |v_s|``:

    - rounding p moves the read by at most ``2^-8 A``;
    - rounding the output, ``2^-8 (|out| + 2^-8 A)``;
    - the f32 logits are off by at most ``(C + L) 2^-24 S`` (``S`` the
      largest ``sum_c |q_c k_c|``), which moves each p by twice that
      relatively, plus a few f32 roundings in exp and the sums:
      ``(2 (C + L) S + L + 16) 2^-24 A``.

    Against the plain version add its own distance from the exact read:
    one output rounding ``2^-8 |out|`` and the same f32 term.
    """
    _, attn, s_abs = _attention_f64(query_map, key, pad_mask)
    v = value.double()
    c, slots = key.shape[2], key.shape[1]
    a_fwd = torch.einsum("bql,blc->bqc", attn, v.abs()).max().item()
    out = torch.einsum("bql,blc->bqc", attn, v).abs().max().item()
    f32 = (2 * (c + slots) * s_abs + slots + 16) * F32_UNIT * a_fwd
    bound = BF16_UNIT * (a_fwd + out + BF16_UNIT * a_fwd) + f32
    if against_plain:
        bound += BF16_UNIT * out + f32
    return bound


def grads_f64(query_map: torch.Tensor, key: torch.Tensor,
              value: torch.Tensor, pad_mask: Optional[torch.Tensor],
              dout: torch.Tensor):
    """The exact gradients (dq [B, H, W, C], dk, dv) in float64, ds zero at
    padding; the sums of the absolute values of the terms that make each
    (over the L slots for dq, the HW pixels for dk and dv), in the same
    shapes; and the largest sum_c |q_c k_c| of any logit."""
    b, h, w, c = query_map.shape
    q, attn, s_abs = _attention_f64(query_map, key, pad_mask)
    k = key.double()
    g = dout.reshape(b, h * w, c).double()
    dattn = torch.einsum("bqc,blc->bql", g, value.double())
    ds = attn * (dattn - (attn * dattn).sum(-1, keepdim=True))
    if pad_mask is not None:
        ds = ds.masked_fill(pad_mask[:, None, :], 0.0)
    sums = (torch.einsum("bql,blc->bqc", ds.abs(), k.abs()),
            torch.einsum("bql,bqc->blc", ds.abs(), q.abs()),
            torch.einsum("bql,bqc->blc", attn, g.abs()))
    exact = (torch.einsum("bql,blc->bqc", ds, k).reshape(query_map.shape),
             torch.einsum("bql,bqc->blc", ds, q),
             torch.einsum("bql,bqc->blc", attn, g))
    return exact, sums, s_abs


def bwd_bf16_bound(query_map: torch.Tensor, key: torch.Tensor,
                   value: torch.Tensor, pad_mask: Optional[torch.Tensor],
                   dout: torch.Tensor,
                   against_plain: bool = False) -> Tuple[float, float, float]:
    """Bounds on the largest absolute error of K2's (dq, dk, dv) in bf16
    against the exact gradients (``against_plain`` False) or against
    :func:`memory_read_bwd_plain` (True), from float64 sums of the inputs.

    K2 rounds P and ds to bf16 before the three products that take them
    (dq = ds k, dk = ds^T q, dv = P^T dout), so each output moves by at
    most ``2^-8`` times the sum of its terms' magnitudes (``T``, from
    :func:`grads_f64`), and once more by its own bf16 rounding,
    ``2^-8 (|out| + 2^-8 T)``.  The f32 sums add ``n 2^-24 T``, with n the
    depth of the kernel's sums plus the C- and L-term sums inside each term
    (as the f32 check counts them): dq sums L slots; dk and dv sum each
    tile's pixels in 16-pixel tensor-core steps, then the tiles in order,
    so their depth is tile/16 + tiles + 16, not HW (at 128x128 and batch
    16: 152, where HW would make the f32 term a quarter of the bf16 one).
    The f32 logits move P, and ds with it, by the relative amount of
    :func:`fwd_bf16_bound`: ``(2 (C + L) S + L + 16) 2^-24 T``.  Against
    the plain version add its own output rounding ``2^-8 |out|`` and its
    f32 sums over L or HW terms.
    """
    b, h, w, c = query_map.shape
    slots, hw = key.shape[1], h * w
    tile = bwd_tile(b, hw)
    depth = tile // 16 + -(-hw // tile) + 16
    exact, sums, s_abs = grads_f64(query_map, key, value, pad_mask, dout)
    eps_p = (2 * (c + slots) * s_abs + slots + 16) * F32_UNIT
    bounds = []
    for n, plain_n, e, a in zip((slots, depth, depth), (slots, hw, hw),
                                exact, sums):
        t, out = a.max().item(), e.abs().max().item()
        bound = (BF16_UNIT * (t + out + BF16_UNIT * t)
                 + ((n + c + slots) * F32_UNIT + eps_p) * t)
        if against_plain:
            bound += (BF16_UNIT * out
                      + ((plain_n + c + slots) * F32_UNIT + eps_p) * t)
        bounds.append(bound)
    return tuple(bounds)


def fwd_f32_bound(channels: int) -> float:
    """How far K1 in f32 may be from :func:`memory_read_plain`: ``3e-6 C``,
    for C-term f32 dot products of unit normals (logits of size ~sqrt(C))
    summed in another order than the plain version sums them.  K1 takes
    each product as 3xTF32, whose terms are off by ~3 * 2^-22 of their
    magnitude, about as much as the f32 sums themselves."""
    return 3e-6 * channels


def bwd_f32_bounds(query_map: torch.Tensor, key: torch.Tensor,
                   value: torch.Tensor, pad_mask: Optional[torch.Tensor],
                   dout: torch.Tensor) -> Tuple[float, float, float]:
    """How far K2's (dq, dk, dv) in f32 may be from
    :func:`memory_read_bwd_plain`: a recursive f32 sum of n terms is off by
    at most ``n 2^-24`` times the sum of the terms' magnitudes (``T``, from
    :func:`grads_f64`); n is L for dq and HW for dk and dv, plus the C- and
    L-term sums inside each term: ``(n + C + L) 2^-24 T``."""
    h, w = query_map.shape[1:3]
    slots, c = key.shape[1:]
    sums = grads_f64(query_map, key, value, pad_mask, dout)[1]
    return tuple((n + c + slots) * F32_UNIT * a.max().item()
                 for n, a in zip((slots, h * w, h * w), sums))


def check_kernel_args(query_map: torch.Tensor, key: torch.Tensor,
                      value: torch.Tensor,
                      pad_mask: Optional[torch.Tensor],
                      dout: Optional[torch.Tensor] = None) -> None:
    """Raise ``ValueError`` on anything the kernels do not take: dtypes
    other than f32/bf16, mismatched shapes or dtypes, non-contiguous
    tensors, bf16 tensors that do not start on a 16-byte boundary (the bf16
    kernels copy rows with 16- and 8-byte loads; the f32 kernels copy 16, 8
    or 4 bytes at a time, as a tensor's start allows), L outside [1, 128], C
    outside [4, 128] or not a multiple of 4, more than 65535 batch rows.
    ``dout`` (the backward's incoming gradient) must match ``query_map`` in
    shape and dtype."""
    if query_map.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"memory_read kernel takes f32 or bf16, not "
                         f"{query_map.dtype}")
    if query_map.dim() != 4:
        raise ValueError(f"query_map must be [B, H, W, C], got "
                         f"{tuple(query_map.shape)}")
    b, _, _, c = query_map.shape
    for name, t in (("key", key), ("value", value)):
        if t.dim() != 3 or t.shape[0] != b or t.shape[2] != c:
            raise ValueError(f"{name} must be [B={b}, L, C={c}], got "
                             f"{tuple(t.shape)}")
        if t.dtype != query_map.dtype:
            raise ValueError(f"{name} must be {query_map.dtype}, got {t.dtype}")
    slots = key.shape[1]
    if value.shape[1] != slots:
        raise ValueError(f"key has {slots} slots, value {value.shape[1]}")
    if pad_mask is not None and (pad_mask.dtype != torch.bool
                                 or tuple(pad_mask.shape) != (b, slots)):
        raise ValueError(f"pad_mask must be bool [{b}, {slots}], got "
                         f"{pad_mask.dtype} {tuple(pad_mask.shape)}")
    if dout is not None and (dout.shape != query_map.shape
                             or dout.dtype != query_map.dtype):
        raise ValueError(f"dout must be {query_map.dtype} "
                         f"{tuple(query_map.shape)}, got {dout.dtype} "
                         f"{tuple(dout.shape)}")
    tensors = [query_map, key, value] + [t for t in (pad_mask, dout)
                                         if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("memory_read kernel takes contiguous tensors")
    if query_map.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in tensors if t is not pad_mask):
        raise ValueError("memory_read kernel takes bf16 tensors that start "
                         "on a 16-byte boundary")
    if not 1 <= slots <= MAX_SLOTS:
        raise ValueError(f"memory_read kernel takes 1..{MAX_SLOTS} slots, "
                         f"got {slots}")
    if not 4 <= c <= MAX_CHANNELS or c % 4:
        raise ValueError(f"memory_read kernel takes C in 4..{MAX_CHANNELS}, "
                         f"a multiple of 4; got {c}")
    if not 1 <= b <= 65535:
        raise ValueError(f"memory_read kernel takes 1..65535 batch rows, "
                         f"got {b}")


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("memory_read").t2igan_memory_read_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def memory_read_fused(query_map: torch.Tensor, key: torch.Tensor,
                      value: torch.Tensor,
                      pad_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The memory read without attention maps.

    On a CUDA tensor this launches the kernel (``key``/``value`` are cast to
    ``query_map``'s dtype first) and raises on any argument it does not
    take; on a CPU tensor it runs :func:`memory_read_plain`.  Returns
    [B, H, W, C] in ``query_map``'s dtype.
    """
    if query_map.device.type == "cpu":
        return memory_read_plain(query_map, key, value, pad_mask)
    if query_map.device.type != "cuda":
        raise ValueError(f"memory_read runs on cuda or cpu, not "
                         f"{query_map.device}")
    key = key.to(query_map.dtype)
    value = value.to(query_map.dtype)
    tensors = [key, value] + ([] if pad_mask is None else [pad_mask])
    if any(t.device != query_map.device for t in tensors):
        raise ValueError("memory_read tensors must share one device")
    check_kernel_args(query_map, key, value, pad_mask)
    b, h, w, c = query_map.shape
    fn = _entry()
    with torch.cuda.device(query_map.device):
        out = torch.empty_like(query_map)
        err = fn(query_map.data_ptr(), key.data_ptr(), value.data_ptr(),
                 None if pad_mask is None else pad_mask.data_ptr(),
                 out.data_ptr(), b, h * w, key.shape[1], c,
                 fwd_tile(b, h * w, query_map.dtype == torch.bfloat16),
                 int(query_map.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"memory_read kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES[KERNEL] += 1
    return out


def _pixel_run(batch: int, hw: int, step: int, blocks: int,
               cap: int) -> int:
    per_block = -(-batch * hw // blocks)
    tile = -(-per_block // step) * step
    return max(step, min(cap, tile))


def fwd_tile(batch: int, hw: int, bf16: bool = True) -> int:
    """Pixels per block of the forward kernel: in bf16 a multiple of its
    128-pixel step, at most 1024, so that about ``BF16_FWD_BLOCKS`` blocks
    cover ``batch * hw`` pixels; in f32 a multiple of its 256-pixel step,
    at most 4096, so that about ``SM_BLOCKS`` blocks do."""
    if bf16:
        return _pixel_run(batch, hw, TC_STEP, BF16_FWD_BLOCKS,
                          BF16_FWD_MAX_TILE)
    return _pixel_run(batch, hw, F32_FWD_STEP, SM_BLOCKS, MAX_TILE)


def bwd_tile(batch: int, hw: int) -> int:
    """Pixels per block of the backward kernel, f32 and bf16: a multiple of
    its 128-pixel step, at most 4096, so that about ``SM_BLOCKS`` blocks
    cover ``batch * hw`` pixels."""
    return _pixel_run(batch, hw, TC_STEP, SM_BLOCKS, MAX_TILE)


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    fn = build.load("memory_read_bwd").t2igan_memory_read_bwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def memory_read_bwd(query_map: torch.Tensor, key: torch.Tensor,
                    value: torch.Tensor, pad_mask: Optional[torch.Tensor],
                    dout: torch.Tensor):
    """Gradients (dq, dk, dv) of the read, in the dtypes of (query_map,
    key, value).

    On a CUDA tensor this launches the backward kernel (``key``, ``value``
    and ``dout`` are cast to ``query_map``'s dtype first; ``dout`` is made
    contiguous) and raises on any argument it does not take; on a CPU
    tensor it runs :func:`memory_read_bwd_plain`.  The kernel writes f32
    partial sums of dk/dv per pixel tile to a workspace and a second
    kernel of the same source sums them in a fixed order, so the result
    is the same from run to run.
    """
    if query_map.device.type == "cpu":
        return memory_read_bwd_plain(query_map, key, value, pad_mask, dout)
    if query_map.device.type != "cuda":
        raise ValueError(f"memory_read runs on cuda or cpu, not "
                         f"{query_map.device}")
    k = key.to(query_map.dtype)
    v = value.to(query_map.dtype)
    g = dout.to(query_map.dtype).contiguous()
    tensors = [k, v, g] + ([] if pad_mask is None else [pad_mask])
    if any(t.device != query_map.device for t in tensors):
        raise ValueError("memory_read tensors must share one device")
    check_kernel_args(query_map, k, v, pad_mask, g)
    b, h, w, c = query_map.shape
    slots, hw = k.shape[1], h * w
    tile = bwd_tile(b, hw)
    n_tiles = -(-hw // tile)
    fn = _bwd_entry()
    with torch.cuda.device(query_map.device):
        dq = torch.empty_like(query_map)
        dk = torch.empty_like(k)
        dv = torch.empty_like(v)
        work = torch.empty((2, b, n_tiles, slots, c), dtype=torch.float32,
                           device=query_map.device)
        err = fn(query_map.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if pad_mask is None else pad_mask.data_ptr(),
                 g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 work.data_ptr(), b, hw, slots, c, tile,
                 int(query_map.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"memory_read backward kernel launch failed with "
                           f"CUDA error {err}")
    LAUNCHES[BWD_KERNEL] += 1
    return dq, dk.to(key.dtype), dv.to(value.dtype)


class MemoryRead(torch.autograd.Function):
    """The read with gradients: forward :func:`memory_read_fused` (K1),
    backward :func:`memory_read_bwd` (K2), the pairing of the JAX
    package's ``custom_vjp``.  ``MemoryRead.apply(query_map, key, value,
    pad_mask)``; the mask gets no gradient."""

    @staticmethod
    def forward(ctx, query_map, key, value, pad_mask):
        ctx.save_for_backward(query_map, key, value, pad_mask)
        return memory_read_fused(query_map, key, value, pad_mask)

    @staticmethod
    def backward(ctx, dout):
        query_map, key, value, pad_mask = ctx.saved_tensors
        dq, dk, dv = memory_read_bwd(query_map, key, value, pad_mask, dout)
        return dq, dk, dv, None
