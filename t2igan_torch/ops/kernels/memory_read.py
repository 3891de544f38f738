"""DM-GAN memory read, forward: the K1 kernel and its plain version.

Port of ``t2igan/ops/pallas/memory_read.py::memory_read_fused`` (forward
only; the backward is a later slice).  On a CUDA tensor
:func:`memory_read_fused` launches the hand-written kernel in
``t2igan_torch/csrc/memory_read.cu`` or raises; on a CPU tensor it runs
:func:`memory_read_plain`.
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


def check_kernel_args(query_map: torch.Tensor, key: torch.Tensor,
                      value: torch.Tensor,
                      pad_mask: Optional[torch.Tensor]) -> None:
    """Raise ``ValueError`` on anything the kernel does not take: dtypes
    other than f32/bf16, mismatched shapes or dtypes, non-contiguous
    tensors, L outside [1, 128], C outside [4, 128] or not a multiple of 4,
    more than 65535 batch rows."""
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
    tensors = [query_map, key, value] + ([] if pad_mask is None else [pad_mask])
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
