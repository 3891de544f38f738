"""The arithmetic of the f32 memory-read kernels (K1 and K2 on the TF32
tensor cores as 3xTF32), held on the CPU.

The CUDA kernels cannot run here, so this file holds what they compute: a
plain-torch emulation in which every f32 operand x is split into
``hi = tf32_rna(x)`` and ``lo = tf32_rna(x - hi)`` (10 mantissa bits, ties
away from zero, as ``cvt.rna.tf32.f32`` rounds; done here on the bits), and
every product a b is taken as ``al bh + ah bl + ah bh``, each part an f32
sum of exact TF32 products.  L and C are zero-padded to the kernels' (LP,
CP); slots past L are left out of the softmax, padding slots get -1e9 and
stay in; the backward's ds is zero at padding and past L.

The emulation is held, on hypothesis-drawn shapes (L 1..128, C a multiple
of 4 up to 128, fully padded rows, 16 to 144 pixels a row), to ``memory_read_plain`` /
``memory_read_bwd_plain`` within the kernels' f32 bounds
(``fwd_f32_bound``, ``bwd_f32_bounds``, the bounds the card's checks hold
the kernels to), and to the float64 read and gradients within the plain
version's own distance from them plus the bound; planted faults fall
outside the bounds: a single TF32 product, the lo part of one operand
dropped, slots past L taken as padding, ds kept at padding.
"""

import sys
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st

from t2igan_torch.ops.kernels.memory_read import (NEG_INF, bwd_f32_bounds,
                                                  fwd_f32_bound, fwd_tile,
                                                  grads_f64,
                                                  memory_read_bwd_plain,
                                                  memory_read_plain, read_f64)


@pytest.fixture(autouse=True, scope="module")
def _hashable_sys_modules():
    """hypothesis hashes every entry of ``sys.modules`` while it draws;
    another test file of the suite registers a ``SimpleNamespace`` there
    as a stub module (``easydict``), which cannot be hashed.  Such entries
    stand in as real modules with the same attributes while this file
    runs."""
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


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's torch ops on one thread: beside the other test
    processes a process that takes every core slows down many times over
    (ROADMAP F26)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tf32_rna(x):
    """x rounded to TF32 (10 mantissa bits), ties away from zero: half a
    TF32 step added to the magnitude bits, the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm3(a, b, fault=None):
    """a @ b as the kernels take it: ``al bh + ah bl + ah bh`` in f32.
    ``fault``: "single" takes ``ah bh`` alone; "lo_dropped" leaves b's lo
    part out (``al bh + ah bh``)."""
    ah, al = split(a)
    bh, bl = split(b)
    if fault == "single":
        return ah @ bh
    if fault == "lo_dropped":
        return al @ bh + ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def _pick(n, sizes):
    return next(s for s in sizes if n <= s)


def _padded(q, k, v, pad):
    """q [B, HW, CP], k and v [B, LP, CP] in f32 with zeros past L and C
    (the kernels' (LP, CP)), and the slot states [B, LP]: excluded (past L)
    and padded (pad_mask)."""
    b, h, w, c = q.shape
    slots = k.shape[1]
    lp = _pick(slots, (16, 32, 64, 80, 128))
    cp = _pick(c, (16, 32, 64, 128))
    qf = F.pad(q.reshape(b, h * w, c), (0, cp - c))
    kf = F.pad(k, (0, cp - c, 0, lp - slots))
    vf = F.pad(v, (0, cp - c, 0, lp - slots))
    excluded = (torch.arange(lp) >= slots)[None, :].expand(b, lp)
    padded = torch.zeros(b, lp, dtype=torch.bool)
    if pad is not None:
        padded[:, :slots] = pad
    return qf, kf, vf, excluded, padded


def _softmax(logits, excluded, padded):
    logits = logits.masked_fill(padded[:, None, :], NEG_INF)
    logits = logits.masked_fill(excluded[:, None, :], -float("inf"))
    return torch.softmax(logits, dim=-1)


def emulate_fwd(q, k, v, pad, fault=None):
    """K1 in f32.  ``fault``: "single" or "lo_dropped" (see :func:`mm3`) in
    both products; "past_L_as_padding" fills the slots past L with -1e9
    and keeps them, as a padding slot."""
    b, h, w, c = q.shape
    qf, kf, vf, excluded, padded = _padded(q, k, v, pad)
    if fault == "past_L_as_padding":
        excluded, padded = excluded & False, padded | excluded
    p = _softmax(mm3(qf, kf.transpose(1, 2), fault), excluded, padded)
    return mm3(p, vf, fault)[..., :c].reshape(b, h, w, c)


def emulate_bwd(q, k, v, pad, dout, fault=None, mm=mm3):
    """K2 in f32: S and dP, P, ds = P (dP - rowsum(P dP)) zero at padding
    and past L, then dq = ds k, dk = ds^T q, dv = P^T dout, every product
    by ``mm``.  ``fault``: "single" or "lo_dropped" in every product;
    "ds_kept_at_padding" leaves ds as it is at padding slots."""
    b, h, w, c = q.shape
    slots = k.shape[1]
    qf, kf, vf, excluded, padded = _padded(q, k, v, pad)
    g = F.pad(dout.reshape(b, h * w, c), (0, kf.shape[2] - c))
    p = _softmax(mm(qf, kf.transpose(1, 2), fault), excluded, padded)
    dp = mm(g, vf.transpose(1, 2), fault)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    if fault != "ds_kept_at_padding":
        ds = ds.masked_fill(padded[:, None, :], 0.0)
    ds = ds.masked_fill(excluded[:, None, :], 0.0)
    dq = mm(ds, kf, fault)[..., :c].reshape(b, h, w, c)
    dk = mm(ds.transpose(1, 2), qf, fault)[:, :slots, :c]
    dv = mm(p.transpose(1, 2), g, fault)[:, :slots, :c]
    return dq, dk, dv


def _inputs(seed, b, h, w, c, slots, mask):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for shape in ((b, h, w, c), (b, slots, c),
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


def test_tf32_rna_rounds_to_nearest_ties_away():
    """Ten mantissa bits kept, the rest rounded to nearest with ties away
    from zero (to even, 1 + step/2 would give 1), both signs; and
    hi + lo within 2^-22 of the value."""
    step = 2.0 ** -10  # a TF32 step at 1
    x = torch.tensor([1 + step / 2, 1 + step / 2 - 2 ** -23, -(1 + step / 2),
                      1 + step, 0.0, float("inf"), 1.5 * 2.0 ** -126])
    want = [1 + step, 1.0, -(1 + step), 1 + step, 0.0, float("inf"),
            1.5 * 2.0 ** -126]
    assert tf32_rna(x).tolist() == want
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    hi, lo = split(x)
    assert (tf32_rna(hi) == hi).all() and (tf32_rna(lo) == lo).all()
    assert ((hi.double() + lo.double() - x.double()).abs()
            <= 2.0 ** -22 * x.double().abs()).all()


# (b, h, w, c, l, mask): C % 8 != 0 (4, 36), C = 128, L = 1, L = 77, L a
# multiple of 16 and not, fully padded rows, ragged HW.
CASES = [
    (2, 5, 7, 4, 1, "none"),
    (2, 9, 7, 36, 33, "ragged"),
    (2, 8, 8, 64, 77, "ragged"),
    (2, 6, 5, 64, 77, "full_row"),
    (1, 4, 4, 128, 128, "full_row"),
    (3, 3, 11, 32, 16, "ragged"),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulation_within_f32_bounds(case):
    """K1's and K2's 3xTF32 arithmetic within the f32 bounds of the plain
    versions and of the float64 read and gradients, at the path shape and
    the edges."""
    q, k, v, pad, g = _inputs(1, *case)
    _check(q, k, v, pad, g)


def _check(q, k, v, pad, g):
    """Within the bound of the plain version, and no farther from the
    float64 result than the plain version plus the bound (the plain f32
    version itself may stand a bound's width from float64 at a few
    pixels: its logits' rounding reaches the gradients through ds)."""
    out = emulate_fwd(q, k, v, pad)
    tol = fwd_f32_bound(q.shape[3])
    plain, exact = memory_read_plain(q, k, v, pad), read_f64(q, k, v, pad)
    assert _err(out, plain) <= tol
    assert _err(out, exact) <= _err(plain, exact) + tol
    grads = emulate_bwd(q, k, v, pad, g)
    tols = bwd_f32_bounds(q, k, v, pad, g)
    for a, r, e, t in zip(grads, memory_read_bwd_plain(q, k, v, pad, g),
                          grads_f64(q, k, v, pad, g)[0], tols):
        assert _err(a, r) <= t
        assert _err(a, e) <= _err(r, e) + t


@settings(max_examples=25, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2 ** 31 - 1), b=st.integers(1, 3),
       h=st.integers(4, 12), w=st.integers(4, 12),
       c=st.integers(1, 32).map(lambda n: 4 * n), slots=st.integers(1, 128),
       mask=st.sampled_from(["none", "ragged", "full_row"]))
def test_emulation_within_f32_bounds_drawn(seed, b, h, w, c, slots, mask):
    """The same on drawn shapes of 16 pixels a row or more (below that
    no f32 arithmetic holds the backward's bound: the next test)."""
    _check(*_inputs(seed, b, h, w, c, slots, mask))


def test_f32_bound_needs_pixels():
    """At one pixel a row the backward's f32 bound is no criterion: a
    backward whose every dot product is exact and rounded once to f32 (as
    good as f32 arithmetic gets) stands outside it against the plain
    version at the path's widths.  ds = P (dP - rowsum(P dP)) cancels
    where one slot takes nearly all the attention, and the rounding of dP
    then reaches dk and dq at more than the bound's share of the terms'
    magnitudes; at many pixels a row the sums over the pixels dilute
    that (the card checks 35 pixels a row and up, this file 16)."""
    q, k, v, pad, g = _inputs(7, 1, 1, 1, 64, 77, "none")
    rounded_once = emulate_bwd(q, k, v, pad, g, mm=lambda a, b, fault=None:
                               (a.double() @ b.double()).float())
    plain = memory_read_bwd_plain(q, k, v, pad, g)
    tols = bwd_f32_bounds(q, k, v, pad, g)
    assert any(_err(a, r) > t for a, r, t in zip(rounded_once, plain, tols))


def test_fully_padded_row_gets_exact_zero_dq_dk():
    """ds is zero on a fully padded row, so its dq and dk are exactly zero
    (hi and lo of 0 are 0), while its dv reads the uniform attention."""
    q, k, v, pad, g = _inputs(6, 2, 6, 5, 64, 77, "full_row")
    dq, dk, dv = emulate_bwd(q, k, v, pad, g)
    assert (dq[-1] == 0).all() and (dk[-1] == 0).all()
    assert dv[-1].abs().max() > 0


@pytest.mark.parametrize("fault", ["single", "lo_dropped"])
@pytest.mark.parametrize("case", [(2, 8, 8, 64, 77, "ragged"),
                                  (1, 6, 5, 32, 16, "none")],
                         ids=lambda c: "-".join(map(str, c)))
def test_bounds_reject_fewer_products(fault, case):
    """One TF32 product, or the lo part of one operand left out, is off by
    ~2^-11 of each term: the f32 bounds reject it in the forward and in
    the backward (against the plain versions), where the three products
    stay inside."""
    q, k, v, pad, g = _inputs(7, *case)
    tol = fwd_f32_bound(q.shape[3])
    plain = memory_read_plain(q, k, v, pad)
    assert _err(emulate_fwd(q, k, v, pad), plain) <= tol
    assert _err(emulate_fwd(q, k, v, pad, fault), plain) > tol
    tols = bwd_f32_bounds(q, k, v, pad, g)
    ref = memory_read_bwd_plain(q, k, v, pad, g)
    bad = emulate_bwd(q, k, v, pad, g, fault)
    assert any(_err(a, r) > t for a, r, t in zip(bad, ref, tols))


@pytest.mark.parametrize("case", [(1, 6, 5, 64, 77, "full_row"),
                                  (1, 4, 4, 36, 33, "full_row")],
                         ids=lambda c: "-".join(map(str, c)))
def test_bound_tells_excluded_slots_from_padding(case):
    """Slots past L taken as -1e9 padding spread a fully padded row over
    LP slots, not L: on values of mean 3 that reads L/LP of their mean,
    far outside the f32 bound."""
    q, k, v, pad, _ = _inputs(3, *case)
    v = v + 3
    assert k.shape[1] % 16
    tol = fwd_f32_bound(q.shape[3])
    exact = read_f64(q, k, v, pad)
    assert _err(emulate_fwd(q, k, v, pad), exact) <= tol
    assert _err(emulate_fwd(q, k, v, pad, "past_L_as_padding"), exact) > tol


@pytest.mark.parametrize("case", [(2, 6, 5, 64, 77, "full_row"),
                                  (2, 4, 4, 36, 33, "full_row")],
                         ids=lambda c: "-".join(map(str, c)))
def test_bwd_bound_rejects_ds_kept_at_padding(case):
    """ds left as it is at padding gives a fully padded row a gradient;
    the f32 bounds against the exact gradients reject it."""
    q, k, v, pad, g = _inputs(5, *case)
    exact = grads_f64(q, k, v, pad, g)[0]
    tols = bwd_f32_bounds(q, k, v, pad, g)
    good = emulate_bwd(q, k, v, pad, g)
    bad = emulate_bwd(q, k, v, pad, g, "ds_kept_at_padding")
    assert all(_err(a, e) <= t for a, e, t in zip(good, exact, tols))
    assert any(_err(a, e) > t for a, e, t in zip(bad, exact, tols))


@pytest.mark.parametrize("batch, hw, tile", [
    (128, 128 * 128, 4096), (128, 64 * 64, 4096), (16, 128 * 128, 2048),
    (16, 64 * 64, 512), (10, 64 * 64, 512), (4, 64 * 64, 256), (1, 5, 256),
    (2, 300000, 4096)])
def test_fwd_tile_f32(batch, hw, tile):
    """Pixels per block of the f32 forward: a multiple of its 256-pixel
    step in [256, 4096], ~132 blocks (one per SM)."""
    assert fwd_tile(batch, hw, bf16=False) == tile
