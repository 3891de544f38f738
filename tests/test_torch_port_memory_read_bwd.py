"""The memory read's backward (K2's plain version and the ``MemoryRead``
autograd pairing) against the JAX package, on the CPU.

Inputs come from numpy seeds.  References: the Pallas backward
``t2igan.ops.pallas.memory_read._backward`` in interpret mode, and
``jax.grad`` through the einsum ``memory_read``.  Tolerance in f32: 1e-5
relative, as the attention ops' parity tests hold, with an absolute floor
of 1e-5 times the largest entry of the reference gradient: dk and dv are
sums over the pixels (dq over the slots) of terms as large as that entry,
and f32 reordering moves such a sum by ~1e-6 of it (measured: at most
3e-6 in these cases).

A fully padded row: its logits do not depend on q or k, so the exact
gradients there are dq = 0 and dk = 0, which ``jax.grad`` gives and the
port gives (ds is zeroed at padding).  The Pallas backward does not zero
ds there, so that row's dq and dk are compared only with ``jax.grad``;
its dv (uniform attention) is compared with both, at an L that is a
multiple of 8 (F7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2igan.ops import attention as jattn
from t2igan.ops.pallas.memory_read import _backward as jbackward
from t2igan_torch.ops.kernels import LAUNCHES
from t2igan_torch.ops.kernels.memory_read import (MemoryRead, bwd_tile,
                                                  check_kernel_args,
                                                  memory_read_bwd,
                                                  memory_read_bwd_plain,
                                                  memory_read_plain)


def _close(actual, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(actual), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def _case(rng, b, h, w, c, l, mask):
    q = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = rng.standard_normal((b, l, c)).astype(np.float32)
    v = rng.standard_normal((b, l, c)).astype(np.float32)
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    pad = None
    if mask != "none":
        lens = rng.integers(3, l + 1, size=b)
        pad = ~(np.arange(l)[None, :] < lens[:, None])
        if mask == "full_row":
            pad[-1] = True
    return q, k, v, pad, g


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _jax_grads(q, k, v, pad, g):
    def f(q, k, v):
        return jnp.sum(jattn.memory_read(q, k, v, _j(pad))[0] * g)
    return jax.grad(f, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))


# (b, h, w, c, l, mask): masked, unmasked and fully padded rows, HW a
# multiple of no tile, L = 77 and L a multiple of 8.
CASES = [
    (3, 16, 16, 64, 11, "ragged"),
    (3, 16, 16, 64, 11, "none"),
    (2, 10, 10, 32, 7, "none"),
    (2, 17, 19, 64, 77, "ragged"),
    (2, 10, 10, 32, 16, "full_row"),
    (2, 9, 7, 36, 77, "full_row"),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_bwd_plain_matches_jax_grad(rng, case):
    q, k, v, pad, g = _case(rng, *case)
    ref = _jax_grads(q, k, v, pad, g)
    out = memory_read_bwd_plain(_t(q), _t(k), _t(v), _t(pad), _t(g))
    for a, r in zip(out, ref):
        _close(a.numpy(), r)


@pytest.mark.parametrize("case", [c for c in CASES if c[4] % 8 == 0
                                  or c[5] != "full_row"],
                         ids=lambda c: "-".join(map(str, c)))
def test_bwd_plain_matches_pallas_interpret(rng, case):
    q, k, v, pad, g = _case(rng, *case)
    ref = [np.asarray(r) for r in
           jbackward(_j(q), _j(k), _j(v), _j(pad), _j(g), True)]
    out = [t.numpy() for t in
           memory_read_bwd(_t(q), _t(k), _t(v), _t(pad), _t(g))]  # CPU
    rows = slice(None, -1) if case[5] == "full_row" else slice(None)
    _close(out[0][rows], ref[0][rows])  # dq
    _close(out[1][rows], ref[1][rows])  # dk
    _close(out[2], ref[2])              # dv


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_memory_read_autograd_matches_jax_grad(rng, case):
    """``MemoryRead`` on CPU tensors: forward and backward plain, the
    gradients jax.grad's, the launch counts untouched."""
    q, k, v, pad, g = _case(rng, *case)
    ref = _jax_grads(q, k, v, pad, g)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    before = dict(LAUNCHES)
    out = MemoryRead.apply(tq, tk, tv, _t(pad))
    torch.testing.assert_close(
        out, memory_read_plain(_t(q), _t(k), _t(v), _t(pad)), rtol=0, atol=0)
    (out * _t(g)).sum().backward()
    for a, r in zip((tq.grad, tk.grad, tv.grad), ref):
        _close(a.numpy(), r)
    assert dict(LAUNCHES) == before


def test_memory_read_autograd_matches_torch_autograd_of_plain(rng):
    q, k, v, pad, g = _case(rng, 2, 6, 5, 16, 9, "full_row")
    a = [_t(x).requires_grad_() for x in (q, k, v)]
    b = [_t(x).requires_grad_() for x in (q, k, v)]
    (MemoryRead.apply(*a, _t(pad)) * _t(g)).sum().backward()
    (memory_read_plain(*b, _t(pad)) * _t(g)).sum().backward()
    for x, y in zip(a, b):
        _close(x.grad.numpy(), y.grad.numpy())


def test_padded_slots_get_zero_dk_dv(rng):
    """Exactly zero dk and dv at every padding slot of a row with a real
    slot; a fully padded row still reads its values (uniform weights), so
    only its dk is zero."""
    q, k, v, pad, g = _case(rng, 3, 8, 8, 16, 11, "full_row")
    _, dk, dv = memory_read_bwd_plain(_t(q), _t(k), _t(v), _t(pad), _t(g))
    assert np.all(dk.numpy()[pad] == 0.0)
    assert np.all(dv.numpy()[:-1][pad[:-1]] == 0.0)
    assert np.abs(dv.numpy()[-1]).max() > 0


def test_bwd_keeps_each_input_dtype(rng):
    q, k, v, pad, g = _case(rng, 2, 4, 4, 8, 5, "ragged")
    dq, dk, dv = memory_read_bwd_plain(_t(q).bfloat16(), _t(k), _t(v).double(),
                                       _t(pad), _t(g).bfloat16())
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16, torch.float32,
                                              torch.float64)


@pytest.mark.parametrize("bad, match", [
    (dict(shape=(2, 4, 5, 8)), "dout must be"),
    (dict(dtype=torch.bfloat16), "dout must be"),
    (dict(noncontig=True), "contiguous"),
])
def test_kernel_argument_checks_for_dout(bad, match):
    q = torch.zeros(2, 4, 4, 8)
    k = torch.zeros(2, 7, 8)
    dout = torch.zeros(bad.get("shape", (2, 4, 4, 8)),
                       dtype=bad.get("dtype", torch.float32))
    if bad.get("noncontig"):
        dout = torch.zeros(2, 8, 4, 4).permute(0, 3, 2, 1)
    with pytest.raises(ValueError, match=match):
        check_kernel_args(q, k, k, None, dout)
    check_kernel_args(q, k, k, None, torch.zeros(2, 4, 4, 8))


@pytest.mark.parametrize("batch, hw, tile", [
    (16, 128 * 128, 1024), (16, 64 * 64, 256), (4, 64 * 64, 64),
    (4, 128 * 128, 256), (1, 5, 32), (2, 300000, 1024)])
def test_bwd_tile(batch, hw, tile):
    """Pixels per block: a multiple of 32 in [32, 1024], ~264 blocks."""
    assert bwd_tile(batch, hw) == tile
