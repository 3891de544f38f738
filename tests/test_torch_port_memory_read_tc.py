"""The rounding points of the bf16 memory-read kernels (K1 and K2 on the
tensor cores), held on the CPU.

The CUDA kernels cannot run here, so this file holds their arithmetic: a
plain-torch emulation of what the bf16 kernels compute (L and C zero-padded
to multiples of 16; slots past L left out of the softmax, padding slots at
-1e9 and kept; P rounded to bf16 before ``P v`` in the forward; P and ds
rounded to bf16 before ``ds k``, ``ds^T q`` and ``P^T dout`` in the
backward; every product summed in f32).  The emulation is held

- in f32, where it rounds nothing, to ``memory_read_plain`` and
  ``memory_read_bwd_plain`` (1e-5, the attention ops' parity bound);
- in bf16, to a float64 read and gradient, within the bounds of
  ``t2igan_torch.ops.kernels.memory_read`` (``fwd_bf16_bound``,
  ``bwd_bf16_bound``), on hypothesis-drawn shapes, while planted faults
  (slots past L taken as padding; ds kept at padding; a 16-pixel step
  dropped from dk and dv) fall outside them;

and the JAX package's Pallas forward at bf16 (interpret mode), which rounds
the attention where K1 does, is held to ``memory_read_plain`` within K1's
bound against the plain version.
"""

import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st

from t2igan.ops.pallas.memory_read import _forward as jforward
from t2igan_torch.ops.kernels.memory_read import (NEG_INF, bwd_bf16_bound,
                                                  bwd_tile, check_kernel_args,
                                                  fwd_bf16_bound, fwd_tile,
                                                  grads_f64,
                                                  memory_read_bwd_plain,
                                                  memory_read_plain, read_f64)


@pytest.fixture(autouse=True, scope="module")
def _hashable_sys_modules():
    """hypothesis hashes every entry of ``sys.modules`` while it draws;
    another test file of the suite registers a ``SimpleNamespace`` there
    as a stub module, which cannot be hashed.  Such entries stand in as
    real modules with the same attributes while this file runs."""
    swapped = {}
    for name, mod in list(sys.modules.items()):
        try:
            hash(mod)
        except TypeError:
            swapped[name] = mod
            stand_in = types.ModuleType(name)
            stand_in.__dict__.update(vars(mod))
            sys.modules[name] = stand_in
    yield
    sys.modules.update(swapped)


def _up16(n):
    return -(-n // 16) * 16


def _padded(q, k, v, pad):
    """q [B, HW, C], k, v [B, LP, CP] in f32 with zeros past L and C, and
    the slot states [B, LP]: excluded (past L) and padded (pad_mask)."""
    b, h, w, c = q.shape
    slots = k.shape[1]
    lp, cp = _up16(slots), _up16(c)
    qf = F.pad(q.reshape(b, h * w, c).float(), (0, cp - c))
    kf = F.pad(k.float(), (0, cp - c, 0, lp - slots))
    vf = F.pad(v.float(), (0, cp - c, 0, lp - slots))
    excluded = (torch.arange(lp) >= slots)[None, :].expand(b, lp)
    padded = torch.zeros(b, lp, dtype=torch.bool)
    if pad is not None:
        padded[:, :slots] = pad
    return qf, kf, vf, excluded, padded


def _softmax(qf, kf, excluded, padded):
    logits = qf @ kf.transpose(1, 2)
    logits = logits.masked_fill(padded[:, None, :], NEG_INF)
    logits = logits.masked_fill(excluded[:, None, :], -float("inf"))
    return torch.softmax(logits, dim=-1)


def emulate_fwd(q, k, v, pad):
    """K1's arithmetic in q's dtype: P rounded to it before ``P v``."""
    b, h, w, c = q.shape
    qf, kf, vf, excluded, padded = _padded(q, k, v, pad)
    p = _softmax(qf, kf, excluded, padded).to(q.dtype).float()
    return (p @ vf)[..., :c].reshape(b, h, w, c).to(q.dtype)


def emulate_bwd(q, k, v, pad, dout, fault=None):
    """K2's arithmetic in q's dtype: P (f32) and dP give ds in f32, zero at
    padding and past L; P and ds are rounded before the three products.

    ``fault`` plants a bug for the bounds to catch: "ds_kept_at_padding"
    leaves ds as it is at padding slots; "phase_b_step_dropped" leaves the
    first 16-pixel step of each pixel tile out of dk and dv."""
    b, h, w, c = q.shape
    slots = k.shape[1]
    qf, kf, vf, excluded, padded = _padded(q, k, v, pad)
    g = F.pad(dout.reshape(b, h * w, c).float(), (0, kf.shape[2] - c))
    p = _softmax(qf, kf, excluded, padded)
    dp = g @ vf.transpose(1, 2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    if fault != "ds_kept_at_padding":
        ds = ds.masked_fill(padded[:, None, :], 0.0)
    ds = ds.masked_fill(excluded[:, None, :], 0.0)
    p = p.to(q.dtype).float()
    ds = ds.to(q.dtype).float()
    dq = (ds @ kf)[..., :c].reshape(b, h, w, c)
    if fault == "phase_b_step_dropped":
        keep = torch.ones(h * w, 1)
        for start in range(0, h * w, bwd_tile(b, h * w, bf16=True)):
            keep[start:start + 16] = 0
        ds, p = ds * keep, p * keep
    dk = (ds.transpose(1, 2) @ qf)[:, :slots, :c]
    dv = (p.transpose(1, 2) @ g)[:, :slots, :c]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _inputs(seed, b, h, w, c, slots, mask, dtype):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype) for shape in ((b, h, w, c), (b, slots, c),
                                             (b, slots, c), (b, h, w, c)))
    pad = None
    if mask != "none":
        lens = rng.integers(min(3, slots), slots + 1, size=b)
        pad = torch.from_numpy(np.arange(slots)[None, :] >= lens[:, None])
        if mask == "full_row":
            pad[-1] = True
    return q, k, v, pad, g


def _err(a, b):
    return (a.double() - b.double()).abs().max().item()


# (b, h, w, c, l, mask): C % 8 != 0 (4, 36), C = 128, L = 1, L = 77, L a
# multiple of 16 and not, a fully padded row, ragged HW.
CASES = [
    (2, 5, 7, 4, 1, "none"),
    (2, 9, 7, 36, 33, "ragged"),
    (2, 8, 8, 64, 77, "ragged"),
    (2, 6, 5, 64, 77, "full_row"),
    (1, 4, 4, 128, 128, "full_row"),
    (3, 3, 11, 32, 16, "ragged"),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulation_f32_matches_plain(case):
    """In f32 the emulation rounds nothing: the padding to 16 and the
    excluded slots change nothing, so it is the plain versions' function."""
    q, k, v, pad, g = _inputs(1, *case, torch.float32)
    out = emulate_fwd(q, k, v, pad)
    ref = memory_read_plain(q, k, v, pad)
    torch.testing.assert_close(out, ref, rtol=1e-5,
                               atol=1e-5 * ref.abs().max().item())
    for a, r in zip(emulate_bwd(q, k, v, pad, g),
                    memory_read_bwd_plain(q, k, v, pad, g)):
        torch.testing.assert_close(a, r, rtol=1e-5,
                                   atol=1e-5 * r.abs().max().item())


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_grads_f64_matches_autograd(case):
    """The float64 gradients the bounds and the card's checks use are
    autograd's of the float64 read."""
    q, k, v, pad, g = _inputs(4, *case, torch.float32)
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    (read_f64(*leaves, pad) * g.double()).sum().backward()
    for a, r in zip(leaves, grads_f64(q, k, v, pad, g)[0]):
        torch.testing.assert_close(a.grad, r, rtol=1e-10, atol=1e-12)


@settings(max_examples=25, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2 ** 31 - 1), b=st.integers(1, 3),
       h=st.integers(1, 12), w=st.integers(1, 12),
       c=st.sampled_from([4, 36, 64, 128]), slots=st.integers(1, 128),
       mask=st.sampled_from(["none", "ragged", "full_row"]))
def test_bf16_emulation_within_bounds(seed, b, h, w, c, slots, mask):
    """The bf16 kernels' arithmetic stays within the stated bounds of the
    exact (float64) read and gradients, and of the plain versions."""
    q, k, v, pad, g = _inputs(seed, b, h, w, c, slots, mask, torch.bfloat16)
    out = emulate_fwd(q, k, v, pad)
    assert _err(out, read_f64(q, k, v, pad)) <= fwd_bf16_bound(q, k, v, pad)
    assert _err(out, memory_read_plain(q, k, v, pad)) <= fwd_bf16_bound(
        q, k, v, pad, against_plain=True)
    grads = emulate_bwd(q, k, v, pad, g)
    for a, e, tol in zip(grads, grads_f64(q, k, v, pad, g)[0],
                         bwd_bf16_bound(q, k, v, pad, g)):
        assert _err(a, e) <= tol
    for a, r, tol in zip(grads, memory_read_bwd_plain(q, k, v, pad, g),
                         bwd_bf16_bound(q, k, v, pad, g, against_plain=True)):
        assert _err(a, r) <= tol


@pytest.mark.parametrize("case", [(2, 8, 8, 64, 77, "ragged"),
                                  (2, 16, 16, 64, 77, "none"),
                                  (2, 9, 7, 36, 33, "ragged"),
                                  (2, 6, 5, 32, 16, "full_row")],
                         ids=lambda c: "-".join(map(str, c)))
def test_pallas_bf16_forward_within_fwd_bound(case):
    """The TPU kernel at bf16 rounds the attention before the read-out, as
    K1 does; the bound covers that choice.  (A fully padded row only at an
    L that is a multiple of 8: F7.)"""
    q, k, v, pad, _ = _inputs(2, *case, torch.bfloat16)
    j = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)]
    ref = jforward(*j, None if pad is None else jnp.asarray(pad.numpy()),
                   True)
    pallas = torch.tensor(np.asarray(ref.astype(jnp.float32)))
    plain = memory_read_plain(q, k, v, pad)
    err = _err(pallas, plain)
    assert 0 < err <= fwd_bf16_bound(q, k, v, pad, against_plain=True)


@pytest.mark.parametrize("case", [(1, 6, 5, 64, 77, "full_row"),
                                  (1, 4, 4, 36, 33, "full_row")],
                         ids=lambda c: "-".join(map(str, c)))
def test_bounds_tell_excluded_slots_from_padding(case):
    """Taking the slots past L as -1e9 padding, not as excluded, spreads a
    fully padded row over the padded L: on values of mean 3 it reads
    L/LP of their mean, and the bound catches that."""
    q, k, v, pad, g = _inputs(3, *case, torch.bfloat16)
    v = v + 3
    b, h, w, c = q.shape
    slots = k.shape[1]
    qf, kf, vf, excluded, padded = _padded(q, k, v, pad)
    wrong = _softmax(qf, kf, excluded & False, padded | excluded)
    wrong = (wrong.to(torch.bfloat16).float() @ vf)[..., :c]
    wrong = wrong.reshape(b, h, w, c).to(torch.bfloat16)
    assert slots % 16
    assert _err(wrong, read_f64(q, k, v, pad)) > fwd_bf16_bound(q, k, v, pad)
    assert _err(emulate_fwd(q, k, v, pad),
                read_f64(q, k, v, pad)) <= fwd_bf16_bound(q, k, v, pad)


@pytest.mark.parametrize("fault, case", [
    ("ds_kept_at_padding", (2, 6, 5, 64, 77, "full_row")),
    ("ds_kept_at_padding", (2, 4, 4, 36, 33, "full_row")),
    ("phase_b_step_dropped", (2, 8, 8, 64, 77, "ragged")),
    ("phase_b_step_dropped", (1, 12, 11, 32, 16, "none"))],
                         ids=lambda c: "-".join(map(str, c))
                         if isinstance(c, tuple) else c)
def test_bwd_bound_catches_planted_faults(fault, case):
    """K2's bound against the exact gradients rejects a backward with ds
    left as it is at padding (a fully padded row then gets a gradient) or
    with one 16-pixel step of each tile left out of dk and dv, while the
    right arithmetic stays inside it.  (A dropped step is caught at these
    few pixels a tile; at 2048, on the card, it would fall inside the
    bound, which sums |terms| over the whole tile.)"""
    q, k, v, pad, g = _inputs(5, *case, torch.bfloat16)
    exact = grads_f64(q, k, v, pad, g)[0]
    tols = bwd_bf16_bound(q, k, v, pad, g)
    good = emulate_bwd(q, k, v, pad, g)
    bad = emulate_bwd(q, k, v, pad, g, fault)
    assert all(_err(a, e) <= t for a, e, t in zip(good, exact, tols))
    assert any(_err(a, e) > t for a, e, t in zip(bad, exact, tols))


@pytest.mark.parametrize("batch, hw, tile", [
    (128, 128 * 128, 1024), (128, 64 * 64, 1024), (16, 128 * 128, 1024),
    (16, 64 * 64, 256), (10, 64 * 64, 256), (1, 5, 128), (2, 300000, 1024)])
def test_fwd_tile(batch, hw, tile):
    """Pixels per block of the bf16 forward: a multiple of its 128-pixel
    step in [128, 1024], ~264 blocks."""
    assert fwd_tile(batch, hw) == tile


@pytest.mark.parametrize("batch, hw, tile", [
    (16, 128 * 128, 2048), (16, 64 * 64, 512), (4, 64 * 64, 128),
    (4, 128 * 128, 512), (1, 5, 128), (2, 300000, 4096)])
def test_bwd_tile_bf16(batch, hw, tile):
    """Pixels per block of the bf16 backward: a multiple of its 128-pixel
    step in [128, 4096], ~132 blocks (one per SM)."""
    assert bwd_tile(batch, hw, bf16=True) == tile


def test_alignment_rule_is_bf16_only():
    """The bf16 kernels copy 16- and 8-byte chunks, so a bf16 tensor must
    start on a 16-byte boundary; the f32 kernels take any f32 pointer."""
    k = torch.zeros(2, 7, 8)
    q = torch.zeros(2 * 4 * 4 * 8 + 1)[1:].view(2, 4, 4, 8)
    check_kernel_args(q, k, k, None)
    qb = torch.zeros(2 * 4 * 4 * 8 + 1, dtype=torch.bfloat16)[1:].view(
        2, 4, 4, 8)
    with pytest.raises(ValueError, match="16-byte"):
        check_kernel_args(qb, k.bfloat16(), k.bfloat16(), None)
    with pytest.raises(ValueError, match="16-byte"):
        check_kernel_args(qb.clone(), k.bfloat16(), k.bfloat16(), None,
                          qb)
    check_kernel_args(qb.clone(), k.bfloat16(), k.bfloat16(), None)
