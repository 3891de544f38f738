"""The arithmetic of the f32 fused-tail kernels (K3 on the TF32 tensor
cores as 3xTF32), held on the CPU.

The CUDA kernels cannot run here, so this file holds what they compute: a
plain-torch emulation of each conv's implicit GEMM per tap (zero-filled
shifted windows, as TMA reads them) in k8 steps.  The window's channels
are split by the test's own ``tf32_rna`` (10 mantissa bits, ties away from
zero, done here on the bits) where the kernel splits them, as it reads its
A fragment; the weights' TF32 hi and lo parts come from
``lay_out_operands``, in the kernels' K order (``F32_K_ORDER``) and GLU
column order.  Each k8 step adds ``a_lo b_hi``, ``a_hi b_lo`` and
``a_hi b_hi`` to one f32 accumulator, in that order, each product exact
and each addition rounded toward zero, as the tensor cores add (on an
H100 the kernels stand from float64 as this emulation does: a few
C 2^-24 of the scale, where plain f32 stands ~1e-6); the epilogues (the
padded affines, GLU, the residual, tanh) stay in f32, the GLU's sigmoid
at the kernels' fast sigmoid's documented worst case.

The emulation is held to ``resblock_chain_up_plain`` in f32 within the
kernels' unchanged f32 bound (``f32_tol``, the bound the card's check
holds them to) and to the tail in float64 within the stricter
``f32_f64_tol``, at small sizes (C = 16 and 32, and 128 at 8x8; R = 1-3;
with and without the head and ``want_h``; ragged grids, H = 1), on fixed
cases and on hypothesis-drawn ones; once against the JAX package's Pallas
kernel in f32 (interpret mode) at 1e-3, its own bound.  Planted faults are
rejected: one TF32 product, ``a_lo b_hi`` dropped, the lo part of B left
out; at C = 128 without the head the worst-case bound alone lets some
through, the float64 check does not.  At the stage-like 16 x 16 with
C = 128 and 256 every fault stands at least twice the float64 check's
limit from float64 and 3xTF32 at most half of it (run with ``-s``, the
margin test prints the readings).
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

from t2igan.ops.pallas import reschain as jrc
from t2igan_torch.ops.kernels import reschain as trc


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


def add_rz(acc, term):
    """f32 ``acc`` + float64 ``term`` rounded toward zero to f32: how the
    tensor cores add a product (exact: TF32 times TF32) to an f32
    accumulator."""
    exact = acc.double() + term
    out = exact.float()
    over = out.double().abs() > exact.abs()
    return torch.where(over, torch.nextafter(out, torch.zeros_like(out)), out)


K_ORDER = torch.tensor(trc.F32_K_ORDER)
TAPS3 = [(u - 1, v - 1) for u in range(3) for v in range(3)]
FAULTS = ("single", "a_lo_dropped", "b_lo_dropped")


def _window(x, dy, dx):
    """x [B, H, W, C] shifted by (dy, dx) with zeros outside: the TMA box of
    one tap, read at (y + dy, x + dx)."""
    _, h, w, _ = x.shape
    padded = F.pad(x, (0, 0, 1, 1, 1, 1))
    return padded[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def _k_ordered(a):
    """a's last axis (a multiple of 16) in the kernels' K order."""
    return a.unflatten(-1, (-1, 16))[..., K_ORDER].flatten(-2)


def _gemm(x, w, offsets, fault=None):
    """One conv as the kernel sums it: for each tap, each k8 step of the
    window's channels (in K order, split as read) against the step's K
    columns of ``w`` [2 (hi, lo), N, taps * Cin], the three products added
    to one f32 accumulator (:func:`add_rz`) in the kernel's order.
    ``fault``: "single" adds ``a_hi b_hi`` alone; "a_lo_dropped" leaves
    ``a_lo b_hi`` out; "b_lo_dropped" leaves ``a_hi b_lo`` out."""
    cin = x.shape[-1]
    bh_all, bl_all = w[0].double(), w[1].double()
    acc = torch.zeros(x.shape[:-1] + (bh_all.shape[0],))
    for tap, (dy, dx) in enumerate(offsets):
        ah, al = (a.double() for a in split(_k_ordered(_window(x, dy, dx))))
        for k in range(0, cin, 8):
            cols = slice(tap * cin + k, tap * cin + k + 8)
            bh, bl = bh_all[:, cols].T, bl_all[:, cols].T
            a_hi, a_lo = ah[..., k:k + 8], al[..., k:k + 8]
            if fault != "single":
                if fault != "a_lo_dropped":
                    acc = add_rz(acc, a_lo @ bh)
                if fault != "b_lo_dropped":
                    acc = add_rz(acc, a_hi @ bl)
            acc = add_rz(acc, a_hi @ bh)
    return acc


def fast_sigmoid(g):
    """The kernels' sigmoid, ``rcp.approx(1 + __expf(-g))``, at its
    documented worst case, every error the same way: ``__expf``'s
    2 + 1.173 |g| ulp (scaled by 1 - sigmoid in the quotient), half an ulp
    in the addition and one in ``rcp.approx``."""
    s = torch.sigmoid(g)
    return s * (1 + ((1 - s) * (2 + 1.173 * g.abs()) + 1.5) * 2.0 ** -23)


def _glu(z, aff):
    """The epilogue's affine (zero-padded past the conv's columns) + GLU on
    GEMM columns in ``glu_column_order``."""
    aff = aff[:, :z.shape[-1]]
    z = z * aff[0] + aff[1]
    z = z.unflatten(-1, (-1, 2, 8))
    return (z[..., 0, :] * fast_sigmoid(z[..., 1, :])).flatten(-2)


def _head(up, w_rgb, fault):
    """The head's GEMM: its threads read 4 channels at once from the split
    halo and the weights alike, so both take the K order (channels past
    C/2 are zeros in the kernel's 16-channel slices)."""
    cin = up.shape[-1]
    pad = -cin % 16
    w = F.pad(w_rgb.unflatten(-1, (9, cin)), (0, pad))
    w = _k_ordered(w).flatten(-2)
    x = F.pad(up, (0, pad))
    # x is k-ordered inside _gemm; w is given in that order already
    return _gemm(x, w, TAPS3, fault)


def emulate(x, ops, want_h, fault=None):
    """What the f32 kernels compute on laid-out operands ``ops``
    (``lay_out_operands(..., torch.float32)``), all in f32."""
    h = x.float()
    for w1, a1, w2, a2 in zip(ops.w1, ops.a1, ops.w2, ops.a2):
        y = _glu(_gemm(h, w1, TAPS3, fault), a1)
        z = _gemm(y, w2, TAPS3, fault)
        a2 = a2[:, :z.shape[-1]]
        h = h + (z * a2[0] + a2[1])
    b, hh, ww, c = h.shape
    up = torch.zeros((b, 2 * hh, 2 * ww, c // 2))
    for phase in range(4):
        pa, pb = phase >> 1, phase & 1
        offsets = [(pa + u - 1, pb + v - 1) for u in range(2) for v in range(2)]
        up[:, pa::2, pb::2] = _glu(_gemm(h, ops.w_up[phase], offsets, fault),
                                   ops.a_up)
    if ops.w_rgb is None:
        return (up,)
    rgb = torch.tanh(_head(up, ops.w_rgb, fault))
    return (up, rgb) if want_h else (rgb,)


def _params(rng, c, n_res, with_rgb):
    """Folded weights, numpy f32: unit-gain conv kernels (std
    1/sqrt(fan in)), BN scales 1 + 0.1 N and shifts 0.1 N."""
    ws = (9 * c) ** -0.5

    def k(*shape, std=ws):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def v(n, mean):
        return (mean + 0.1 * rng.standard_normal(n)).astype(np.float32)

    rb = [(k(3, 3, c, 2 * c), v(2 * c, 1.0), v(2 * c, 0.0),
           k(3, 3, c, c), v(c, 1.0), v(c, 0.0)) for _ in range(n_res)]
    rgb = k(3, 3, c // 2, 3, std=(4.5 * c) ** -0.5) if with_rgb else None
    return rb, k(3, 3, c, c), v(c, 1.0), v(c, 0.0), rgb


def _case(seed, b, h, w, c, n_res, with_rgb):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    rb, up_k, up_s, up_b, rgb = _params(rng, c, n_res, with_rgb)
    t = torch.from_numpy
    folded = ([tuple(t(a) for a in p) for p in rb], t(up_k), t(up_s),
              t(up_b), None if rgb is None else t(rgb))
    return t(x), folded, (x, rb, up_k, up_s, up_b, rgb)


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _references(x, folded, want_h):
    """The plain tail in f32 and in float64."""
    plain = _tuple(trc.resblock_chain_up_plain(x, *folded, want_h=want_h))
    rb, up_k, up_s, up_b, rgb = folded
    d = torch.Tensor.double
    exact = _tuple(trc.resblock_chain_up_plain(
        d(x), [tuple(d(a) for a in p) for p in rb], d(up_k), d(up_s),
        d(up_b), None if rgb is None else d(rgb), want_h=want_h))
    return plain, exact


def _err(a, b):
    return (a.double() - b.double()).abs().max().item()


def _verdicts(out, plain, exact, c):
    """Per output: (within f32_tol of the plain f32 tail, within
    f32_f64_tol of the float64 tail)."""
    res = []
    for o, p, e in zip(out, plain, exact):
        scale = e.abs().max().item()
        res.append((_err(o, p) <= trc.f32_tol(c, scale),
                    _err(o, e) <= trc.f32_f64_tol(_err(p, e), c, scale)))
    return res


def test_add_rz_rounds_toward_zero():
    """The accumulator's addition: toward zero on both signs, exact where
    f32 holds the sum."""
    one = torch.tensor([1.0, -1.0, 1.0])
    tiny = torch.tensor([2.0 ** -30, -(2.0 ** -30), 0.5], dtype=torch.float64)
    assert add_rz(one, tiny).tolist() == [1.0, -1.0, 1.5]
    assert add_rz(torch.tensor([1.0]), torch.tensor(
        [-(2.0 ** -30)], dtype=torch.float64)).item() == 1.0 - 2.0 ** -24


def test_tf32_split_is_the_kernels():
    """The package's split (the f32 weights' hi and lo) rounds as the
    kernels' ``mr::tf32_rna`` and this file's: ten mantissa bits, ties away
    from zero, both signs; hi + lo within 2^-22 of the value, both TF32."""
    step = 2.0 ** -10
    x = torch.tensor([1 + step / 2, 1 + step / 2 - 2 ** -23, -(1 + step / 2),
                      1 + step, 0.0, 1.5 * 2.0 ** -126])
    assert trc.tf32_rna(x).tolist() == [1 + step, 1.0, -(1 + step), 1 + step,
                                        0.0, 1.5 * 2.0 ** -126]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096).astype(np.float32))
    hi, lo = trc.split_tf32(x)
    assert torch.equal(hi, tf32_rna(x)) and torch.equal(lo, split(x)[1])
    assert torch.equal(tf32_rna(hi), hi) and torch.equal(tf32_rna(lo), lo)
    assert ((hi.double() + lo.double() - x.double()).abs()
            <= 2.0 ** -22 * x.double().abs()).all()


def test_k_order_is_the_fragment_order():
    """Thread t reads channels 4t .. 4t + 3 of a 16-channel slice and gives
    them to k = t, t + 4 of step 0 and k = t, t + 4 of step 1: K position
    8s + k holds that channel, and every channel appears once."""
    order = trc.F32_K_ORDER
    assert sorted(order) == list(range(16))
    for t in range(4):
        for s in range(2):
            assert order[8 * s + t] == 4 * t + 2 * s
            assert order[8 * s + t + 4] == 4 * t + 2 * s + 1


# (seed, b, h, w, c, R, RGB head, want_h): C = 16 and 32, R = 1-3, ragged
# grids, H = 1, the head alone and with up; C = 128 at 8x8 (the path's
# width, where the worst-case bound is widest).
CASES = [
    (0, 2, 9, 13, 16, 1, True, True),
    (1, 2, 16, 16, 32, 2, True, True),
    (2, 1, 8, 8, 16, 3, False, True),
    (3, 2, 7, 16, 32, 3, True, False),
    (4, 3, 1, 16, 16, 2, True, True),
    (5, 1, 8, 8, 128, 2, True, True),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulation_within_f32_bounds(case):
    """3xTF32 through the chain within f32_tol of the plain f32 tail and
    within f32_f64_tol of the float64 tail, at every output."""
    seed, b, h, w, c, n_res, with_rgb, want_h = case
    x, folded, _ = _case(seed, b, h, w, c, n_res, with_rgb)
    ops = trc.lay_out_operands(*folded, torch.float32)
    out = emulate(x, ops, want_h)
    plain, exact = _references(x, folded, want_h)
    assert [o.shape for o in out] == [p.shape for p in plain]
    assert _verdicts(out, plain, exact, c) == [(True, True)] * len(out)


@settings(max_examples=12, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2 ** 31 - 1), b=st.integers(1, 2),
       h=st.integers(1, 12), w=st.integers(1, 12),
       c=st.sampled_from([16, 32]), n_res=st.integers(1, 3),
       head=st.sampled_from(["none", "rgb only", "both"]))
def test_emulation_within_f32_bounds_drawn(seed, b, h, w, c, n_res, head):
    want_h = head != "rgb only"
    x, folded, _ = _case(seed, b, h, w, c, n_res, head != "none")
    out = emulate(x, trc.lay_out_operands(*folded, torch.float32), want_h)
    plain, exact = _references(x, folded, want_h)
    assert _verdicts(out, plain, exact, c) == [(True, True)] * len(out)


def test_emulation_is_the_pallas_kernel_in_f32():
    """The JAX package's Pallas kernel in f32 (interpret mode) sums each
    conv in f32 and rounds nowhere else: the emulation is within 1e-3 of
    it, the JAX package's bound against an interpreted kernel."""
    x, folded, (xn, rb, up_k, up_s, up_b, rgb) = _case(7, 2, 9, 11, 16, 2,
                                                       True)
    out = emulate(x, trc.lay_out_operands(*folded, torch.float32), True)
    pallas = jrc.resblock_chain_up_fused(
        jnp.asarray(xn), [tuple(jnp.asarray(a) for a in p) for p in rb],
        jnp.asarray(up_k), jnp.asarray(up_s), jnp.asarray(up_b),
        rgb_kernel=jnp.asarray(rgb), want_h=True, row_chunk=9,
        interpret=True)
    for o, p in zip(out, _tuple(pallas)):
        np.testing.assert_allclose(o.numpy(), np.asarray(p), rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("case", [(1, 2, 16, 16, 32, 2, True, True),
                                  (5, 1, 8, 8, 128, 2, False, True)],
                         ids=lambda c: "-".join(map(str, c)))
def test_bounds_reject_planted_faults(fault, case):
    """One TF32 product, ``a_lo b_hi`` dropped or B's lo part left out is
    off by ~2^-11 of each term: the two checks together reject it at some
    output, where 3xTF32 passes both at every output."""
    seed, b, h, w, c, n_res, with_rgb, want_h = case
    x, folded, _ = _case(seed, b, h, w, c, n_res, with_rgb)
    ops = trc.lay_out_operands(*folded, torch.float32)
    plain, exact = _references(x, folded, want_h)
    good = _verdicts(emulate(x, ops, want_h), plain, exact, c)
    assert all(a and e for a, e in good)
    bad = _verdicts(emulate(x, ops, want_h, fault), plain, exact, c)
    assert not all(a and e for a, e in bad)


def test_worst_case_bound_needs_the_f64_check():
    """At the path's width (C = 128) without the head, ``a_lo b_hi``
    dropped stays within the worst-case f32_tol of the plain tail (9C
    terms, five convs deep: 3.4e-4 of the scale): only the float64 check
    tells it from 3xTF32."""
    x, folded, _ = _case(5, 1, 8, 8, 128, 2, False)
    ops = trc.lay_out_operands(*folded, torch.float32)
    plain, exact = _references(x, folded, True)
    bad = _verdicts(emulate(x, ops, True, "a_lo_dropped"), plain, exact, 128)
    assert bad == [(True, False)]


@pytest.mark.parametrize("case", [(8, 1, 16, 16, 128, 2, True, True),
                                  (9, 1, 16, 16, 256, 1, True, True)],
                         ids=lambda c: "-".join(map(str, c)))
def test_f64_limit_margin(case):
    """At a stage-like 16 x 16 grid, C = 128 and 256: at its worst output
    each planted fault stands at least twice f32_f64_tol's limit from the
    float64 tail, and 3xTF32 at most half of it (the readings, in
    C 2^-24 of the scale past twice the plain error, are printed: where
    the limit sits between what passes and what fails)."""
    seed, b, h, w, c, n_res, with_rgb, want_h = case
    x, folded, _ = _case(seed, b, h, w, c, n_res, with_rgb)
    ops = trc.lay_out_operands(*folded, torch.float32)
    plain, exact = _references(x, folded, want_h)
    unit = c * trc.F32_UNIT
    for fault in (None,) + FAULTS:
        out = emulate(x, ops, want_h, fault)
        ratios, readings = [], []
        for o, p, e in zip(out, plain, exact):
            scale, plain_err = e.abs().max().item(), _err(p, e)
            ratios.append(_err(o, e) / trc.f32_f64_tol(plain_err, c, scale))
            readings.append((_err(o, e) - 2 * plain_err) / (unit * scale))
        print(f"C={c} {fault or '3xTF32'}: of the limit "
              f"{[round(r, 3) for r in ratios]}, C 2^-24 of the scale "
              f"{[round(r, 2) for r in readings]}, limit "
              f"{min(12, 2.0 ** -13 / unit):.2f}")
        if fault is None:
            assert max(ratios) <= 0.5
        else:
            assert max(ratios) >= 2.0
