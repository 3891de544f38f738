"""The port's attention ops against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both sides.  The
memory read is held against the einsum form (``t2igan.ops.attention``) and
against the Pallas kernel in interpret mode; f32 tolerance 1e-5 absolute
and relative, as ``tests/test_memory_read_fused.py`` holds the two JAX
forms to each other.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2igan.ops import attention as jattn
from t2igan.ops.pallas.memory_read import memory_read_fused as jfused
from t2igan_torch.ops import attention as tattn
from t2igan_torch.ops.kernels.memory_read import (check_kernel_args,
                                                  memory_read_fused,
                                                  memory_read_plain)

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(rng, b, h, w, c, l, mask):
    q = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = rng.standard_normal((b, l, c)).astype(np.float32)
    v = rng.standard_normal((b, l, c)).astype(np.float32)
    if mask == "none":
        pad = None
    else:
        lens = rng.integers(3, l + 1, size=b)
        pad = ~(np.arange(l)[None, :] < lens[:, None])
        if mask == "full_row":
            pad[-1] = True  # one row with every slot padded
    return q, k, v, pad


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# (b, h, w, c, l, mask): the cases of tests/test_memory_read_fused.py, a
# fully padded row, HW a multiple of no tile (10x10, 17x19) and L = 77.
CASES = [
    (3, 16, 16, 64, 11, "ragged"),
    (3, 16, 16, 64, 11, "none"),
    (2, 10, 10, 32, 7, "none"),
    (2, 17, 19, 64, 77, "ragged"),
    (2, 8, 8, 64, 77, "none"),
    (2, 10, 10, 32, 16, "full_row"),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_memory_read_plain_matches_jax_einsum(rng, case):
    q, k, v, pad = _case(rng, *case)
    ref, ref_attn = jattn.memory_read(_j(q), _j(k), _j(v), _j(pad))
    out = memory_read_plain(_t(q), _t(k), _t(v), _t(pad))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    read, attn = tattn.memory_read(_t(q), _t(k), _t(v), _t(pad))
    np.testing.assert_allclose(read.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(ref_attn), **TOL)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_memory_read_plain_matches_pallas_interpret(rng, case):
    """The fully padded row is held to the Pallas kernel only at an L that
    is a multiple of 8: the kernel pads L to a multiple of 8 and its padded
    slots take part in a fully padded row's uniform weights, where the
    einsum form (and the port) spread them over the L real slots."""
    q, k, v, pad = _case(rng, *case)
    ref = jfused(_j(q), _j(k), _j(v), _j(pad), True)
    out = memory_read_fused(_t(q), _t(k), _t(v), _t(pad))  # CPU: plain
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_fully_padded_row_is_uniform(rng):
    q, k, v, pad = _case(rng, 2, 4, 4, 8, 5, "full_row")
    _, attn = tattn.memory_read(_t(q), _t(k), _t(v), _t(pad))
    np.testing.assert_allclose(attn[-1].numpy(), np.full((4, 4, 5), 0.2),
                               rtol=1e-6)


def test_memory_read_plain_keeps_model_dtype(rng):
    q, k, v, pad = _case(rng, 2, 4, 4, 8, 5, "ragged")
    out = memory_read_plain(_t(q).bfloat16(), _t(k).bfloat16(),
                            _t(v).bfloat16(), _t(pad))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 4, 4, 8)


@pytest.mark.parametrize("bad, match", [
    (dict(l=129), "slots"),
    (dict(c=66), "multiple of 4"),
    (dict(c=132), "multiple of 4"),
    (dict(dtype=torch.float16), "f32 or bf16"),
    (dict(noncontig=True), "contiguous"),
    (dict(mask_dtype=torch.int32), "pad_mask"),
    (dict(dtype=torch.bfloat16, misaligned=True), "16-byte"),
])
def test_kernel_argument_checks(bad, match):
    """What the CUDA kernel does not take is refused before any launch."""
    b, l, c = 2, bad.get("l", 7), bad.get("c", 8)
    dtype = bad.get("dtype", torch.float32)
    q = torch.zeros(b, 4, 4, c, dtype=dtype)
    if bad.get("noncontig"):
        q = torch.zeros(b, c, 4, 4, dtype=dtype).permute(0, 3, 2, 1)
    if bad.get("misaligned"):
        q = torch.zeros(b * 4 * 4 * c + 1, dtype=dtype)[1:].view(b, 4, 4, c)
    k = torch.zeros(b, l, c, dtype=dtype)
    pad = torch.zeros(b, l, dtype=bad.get("mask_dtype", torch.bool))
    with pytest.raises(ValueError, match=match):
        check_kernel_args(q, k, k, pad)


def test_kernel_argument_checks_accept_channels_last_query():
    """An NCHW channels-last map permuted to NHWC is what the generator
    hands the kernel: contiguous, no copy."""
    h = torch.zeros(2, 64, 8, 8).contiguous(memory_format=torch.channels_last)
    k = torch.zeros(2, 77, 64)
    check_kernel_args(h.permute(0, 2, 3, 1), k, k, torch.zeros(2, 77,
                                                               dtype=torch.bool))


def test_l2_normalize_and_masked_softmax(rng):
    x = rng.standard_normal((3, 5, 7)).astype(np.float32)
    mask = rng.random((3, 5, 7)) > 0.4
    mask[0, 0] = False  # a fully masked row
    np.testing.assert_allclose(tattn.l2_normalize(_t(x)).numpy(),
                               np.asarray(jattn.l2_normalize(_j(x))), **TOL)
    np.testing.assert_allclose(
        tattn.masked_softmax(_t(x), _t(mask)).numpy(),
        np.asarray(jattn.masked_softmax(_j(x), _j(mask))), **TOL)
    np.testing.assert_allclose(
        tattn.masked_softmax(_t(x), None, dim=1).numpy(),
        np.asarray(jattn.masked_softmax(_j(x), None, axis=1)), **TOL)


@pytest.mark.parametrize("with_mask", [True, False])
def test_word_region_attention(rng, with_mask):
    words = rng.standard_normal((2, 9, 16)).astype(np.float32)
    regions = rng.standard_normal((2, 50, 16)).astype(np.float32)
    mask = (np.arange(9)[None, :] < np.array([[6], [9]])) if with_mask else None
    ctx, attn = tattn.word_region_attention(_t(words), _t(regions),
                                            _t(mask), 5.0)
    jctx, jat = jattn.word_region_attention(_j(words), _j(regions),
                                            _j(mask), 5.0)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), **TOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(jat), **TOL)
