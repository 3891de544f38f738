"""DM-GAN memory read: the K1 (forward) and K2 (backward) kernels, their
plain versions, and :class:`MemoryRead`, the autograd pairing of the two.

Port of ``t2igan/ops/pallas/memory_read.py::memory_read_fused`` and its
``custom_vjp``.  On a CUDA tensor :func:`memory_read_fused` launches the
hand-written kernel in ``t2igan_torch/csrc/memory_read.cu`` and
:func:`memory_read_bwd` the one in ``csrc/memory_read_bwd.cu``, or they
raise; on a CPU tensor they run :func:`memory_read_plain` and
:func:`memory_read_bwd_plain`.  Neither falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from t2igan_torch.ops.kernels import LAUNCHES, build

NEG_INF = -1e9  # padding fill, as in the JAX package
MAX_SLOTS = 128
MAX_CHANNELS = 128
KERNEL = "memory_read_fwd"
BWD_KERNEL = "memory_read_bwd"
# The backward kernel walks its pixels in sub-tiles of 32 (csrc); the
# wrapper picks the pixels per block so that about TARGET_BLOCKS blocks
# (two per SM of an H100) share the work.
BWD_SUB_TILE = 32
BWD_MAX_TILE = 1024
TARGET_BLOCKS = 264


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


def check_kernel_args(query_map: torch.Tensor, key: torch.Tensor,
                      value: torch.Tensor,
                      pad_mask: Optional[torch.Tensor],
                      dout: Optional[torch.Tensor] = None) -> None:
    """Raise ``ValueError`` on anything the kernels do not take: dtypes
    other than f32/bf16, mismatched shapes or dtypes, non-contiguous
    tensors, L outside [1, 128], C outside [4, 128] or not a multiple of 4,
    more than 65535 batch rows.  ``dout`` (the backward's incoming
    gradient) must match ``query_map`` in shape and dtype."""
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
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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
                 int(query_map.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"memory_read kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES[KERNEL] += 1
    return out


def bwd_tile(batch: int, hw: int) -> int:
    """Pixels per block of the backward kernel: a multiple of the 32-pixel
    sub-tile, at most 1024, chosen so that about ``TARGET_BLOCKS`` blocks
    cover ``batch * hw`` pixels."""
    per_block = -(-batch * hw // TARGET_BLOCKS)
    tile = -(-per_block // BWD_SUB_TILE) * BWD_SUB_TILE
    return max(BWD_SUB_TILE, min(BWD_MAX_TILE, tile))


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
