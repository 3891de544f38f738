"""What the bf16 fused-tail kernels (K3 on ``wgmma`` + TMA) take from
Python, held on the CPU.

The CUDA kernels cannot run here, so this file holds everything around
them:

- the operand layout: a plain-torch emulation of the kernels' implicit
  GEMM (zero-filled shifted windows per tap, as TMA reads them, times the
  wrapper's laid-out B operands; the GLU value and gate columns taken
  apart as the epilogue does) equals ``resblock_chain_up_plain`` in f32
  (1e-5, the fold's parity bound), with weights that bf16 holds exactly;
- the rounding points: the same emulation, rounding y, h, up and rgb to
  bf16 and summing each conv in f32, stays within one bf16 step of the
  JAX package's Pallas kernel at bf16 (interpret mode), which rounds at
  those points, and closer to it than the unrounded emulation is;
- ``tile_geometry``: for hypothesis-drawn grids the tiles cover every
  output pixel once, none leaves its image, and every TMA box fits
  (dimensions <= 256, an inner row of 128 bytes under the 128-byte
  swizzle, of 64 under the 64-byte one for the C -> C convs and for
  every f32 box), the f32 tiles being the bf16 ones; the f32 layout
  (TF32 hi and lo parts, the GLU column order, ``F32_K_ORDER``);
- the laid-out operands kept on a fused stage follow in-place changes of
  its weights and running statistics.
"""

import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from t2igan.ops.pallas import reschain as jrc
from t2igan_torch.ops.kernels import reschain as trc
from test_torch_port_generator import _nhwc
from test_torch_port_reschain import CHAIN_TOL, _next_stage_pair


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's torch ops on one thread: beside the other test
    processes a process that takes every core slows down many times over
    (ROADMAP F26)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LAYOUT_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_STEP = 2.0 ** -7  # one bf16 step, relative to the leading bit


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


def _params(rng, c, n_res, with_rgb):
    """Folded weights, numpy f32.  Conv kernels are multiples of 1/256 in
    [-1/16, 1/16] (unit gain at C = 16), so bf16 holds them, and the sums
    of up to four of them in the subpixel phase kernels, exactly."""
    def k(*shape):
        return (rng.integers(-16, 17, size=shape) / 256).astype(np.float32)

    def v(n, mean):
        return (mean + 0.1 * rng.standard_normal(n)).astype(np.float32)

    rb = [(k(3, 3, c, 2 * c), v(2 * c, 1.0), v(2 * c, 0.0),
           k(3, 3, c, c), v(c, 1.0), v(c, 0.0)) for _ in range(n_res)]
    rgb = k(3, 3, c // 2, 3) if with_rgb else None
    return rb, k(3, 3, c, c), v(c, 1.0), v(c, 0.0), rgb


def _torch_args(x, rb, up_k, up_s, up_b, rgb, dtype):
    """numpy args as torch: activations and conv kernels in ``dtype``,
    the BN affines in f32."""
    def t(a):
        return torch.from_numpy(a).to(dtype if a.ndim == 4 else torch.float32)

    return (t(x), [tuple(t(a) for a in p) for p in rb], t(up_k), t(up_s),
            t(up_b), None if rgb is None else t(rgb))


def _window(x, dy, dx):
    """x [B, H, W, C] shifted by (dy, dx) with zeros outside: the TMA box of
    one tap, read at (y + dy, x + dx)."""
    _, h, w, _ = x.shape
    padded = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    return padded[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def _gemm(x, weight, offsets):
    """The implicit GEMM of one conv: sum over taps of the tap's window
    times its K slice of ``weight`` [N, taps * Cin], in f32."""
    cin = x.shape[-1]
    out = 0
    for tap, (dy, dx) in enumerate(offsets):
        out = out + _window(x, dy, dx) @ weight[:, tap * cin:(tap + 1) * cin].T
    return out


def _glu(z, aff):
    """The bf16 epilogue's affine (zero-padded past the conv's columns) +
    GLU on GEMM columns in ``glu_column_order``: column 16q + i (i < 8) is
    channel 8q + i's value, 16q + 8 + i its gate."""
    aff = aff[:, :z.shape[-1]]
    z = z * aff[0] + aff[1]
    z = z.unflatten(-1, (-1, 2, 8))
    return (z[..., 0, :] * torch.sigmoid(z[..., 1, :])).flatten(-2)


TAPS3 = [(u - 1, v - 1) for u in range(3) for v in range(3)]


def emulate(x, ops, want_h, round_bf16):
    """What the bf16 kernels compute, in f32 on laid-out operands ``ops``
    (``lay_out_operands(..., torch.bfloat16)``); with ``round_bf16`` y, h,
    up and rgb are rounded to bf16 where the kernels round them."""
    def rnd(t):
        return t.to(torch.bfloat16).float() if round_bf16 else t

    h = x.float()
    for w1, a1, w2, a2 in zip(ops.w1, ops.a1, ops.w2, ops.a2):
        y = rnd(_glu(_gemm(h, w1.float(), TAPS3), a1))
        z = _gemm(y, w2.float(), TAPS3)
        a2 = a2[:, :z.shape[-1]]
        h = rnd(h + (z * a2[0] + a2[1]))
    b, hh, ww, c = h.shape
    up = torch.zeros((b, 2 * hh, 2 * ww, c // 2))
    for phase in range(4):
        pa, pb = phase >> 1, phase & 1
        offsets = [(pa + u - 1, pb + v - 1) for u in range(2) for v in range(2)]
        up[:, pa::2, pb::2] = _glu(_gemm(h, ops.w_up[phase].float(), offsets),
                                   ops.a_up)
    up = rnd(up)
    if ops.w_rgb is None:
        return (up,)
    rgb = rnd(torch.tanh(_gemm(up, ops.w_rgb.float(), TAPS3)))
    return (up, rgb) if want_h else (rgb,)


@pytest.mark.parametrize("with_rgb", [False, True])
@pytest.mark.parametrize("n_res", [1, 2])
@pytest.mark.parametrize("c", [16, 32])
def test_operand_layout_is_the_plain_tail(c, n_res, with_rgb):
    rng = np.random.default_rng(c + 10 * n_res + with_rgb)
    x = rng.standard_normal((2, 17, 19, c)).astype(np.float32)
    params = _params(rng, c, n_res, with_rgb)
    x32, *folded = _torch_args(x, *params, dtype=torch.float32)
    # The bf16 kernels' layout; the weights survive the cast exactly.
    ops = trc.lay_out_operands(*folded, torch.bfloat16)
    assert all(w.dtype == torch.bfloat16 for w in ops.w1 + ops.w2)
    got = emulate(x32, ops, True, round_bf16=False)
    want = trc.resblock_chain_up_plain(x32, *folded, want_h=True)
    want = want if isinstance(want, tuple) else (want,)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **LAYOUT_TOL)


def test_glu_column_order_pairs_values_with_gates():
    order = trc.glu_column_order(64).tolist()
    assert sorted(order) == list(range(64))
    for q in range(4):
        for i in range(8):
            assert order[16 * q + i] == 8 * q + i            # value
            assert order[16 * q + 8 + i] == 32 + 8 * q + i   # its gate
    with pytest.raises(ValueError, match="groups of 16"):
        trc.glu_column_order(24)


@pytest.mark.parametrize("c", [16, 128, 192])
def test_bf16_affines_are_padded(c):
    rng = np.random.default_rng(c)
    _, *folded = _torch_args(np.zeros((1, 2, 2, c), np.float32),
                             *_params(rng, c, 1, False), dtype=torch.float32)
    ops = trc.lay_out_operands(*folded, torch.bfloat16)
    for a, cols in ((ops.a1[0], 2 * c), (ops.a2[0], c), (ops.a_up, c)):
        assert a.shape == (2, -(-cols // trc.AFFINE_PAD) * trc.AFFINE_PAD)
        assert torch.all(a[:, cols:] == 0)
    order = trc.glu_column_order(2 * c)
    np.testing.assert_array_equal(ops.a1[0][:, :2 * c].numpy(),
                                  torch.stack(folded[0][0][1:3])[:, order].numpy())


def test_f32_layout_keeps_values_then_gates():
    """The f32 layout: each weight as TF32 hi and lo parts whose sum is the
    folded weight (exactly, for weights of 21 significant bits; within
    2^-22 for any), the GLU convs' columns in glu_column_order (each
    channel's value beside its gate), the convs' input channels in
    F32_K_ORDER (the head's as given), the affines padded as in bf16."""
    rng = np.random.default_rng(0)
    c = 32
    _, *folded = _torch_args(np.zeros((1, 2, 2, c), np.float32),
                             *_params(rng, c, 1, True), dtype=torch.float32)
    rb, up_k, up_s, up_b, rgb = folded
    g = torch.Generator().manual_seed(1)

    def wide(*shape):
        # f32 weights with 21 significant bits (the low 3 cleared)
        w = torch.randn(shape, generator=g) * 0.1
        return (w.view(torch.int32) & -8).view(torch.float32)

    k1, k2, up_k, rgb = wide(3, 3, c, 2 * c), wide(3, 3, c, c), \
        wide(3, 3, c, c), wide(3, 3, c // 2, 3)
    rb = [(k1, *rb[0][1:3], k2, *rb[0][4:])]
    ops = trc.lay_out_operands(rb, up_k, up_s, up_b, rgb, torch.float32)
    order = trc.glu_column_order(2 * c)
    k_order = torch.tensor(trc.F32_K_ORDER)

    def gemm(kernel):  # [..., 3, 3, cin, cout] -> [..., cout, 9, cin]
        return kernel.movedim(-1, -4).flatten(-3, -2)

    def k_ordered(w):
        return w.unflatten(-1, (-1, 16))[..., k_order].flatten(-3)

    want = {"w1": k_ordered(gemm(k1)[order]), "w2": k_ordered(gemm(k2)),
            "w_up": k_ordered(gemm(trc.phase_kernels(up_k))
                              [:, trc.glu_column_order(c)]),
            "w_rgb": gemm(rgb).flatten(-2)}
    got = {"w1": ops.w1[0], "w2": ops.w2[0], "w_up": ops.w_up,
           "w_rgb": ops.w_rgb}
    for name, w in want.items():
        parts = got[name]
        assert parts.dtype == torch.float32
        hi, lo = parts.unbind(-3)
        assert hi.shape == w.shape, name
        for part in (hi, lo):
            np.testing.assert_array_equal(trc.tf32_rna(part).numpy(),
                                          part.numpy())
        if name != "w_up":  # the phase kernels are sums of taps
            np.testing.assert_array_equal((hi + lo).numpy(), w.numpy())
        assert ((hi.double() + lo.double() - w.double()).abs()
                <= 2.0 ** -22 * w.double().abs()).all(), name
    # each value's gate: GEMM column 16q + i and 16q + 8 + i
    np.testing.assert_array_equal(order[:8].numpy(), np.arange(8))
    np.testing.assert_array_equal(order[8:16].numpy(), c + np.arange(8))
    a1 = ops.a1[0]
    assert a1.shape == (2, trc.AFFINE_PAD) and torch.all(a1[:, 2 * c:] == 0)
    np.testing.assert_array_equal(a1[:, :2 * c].numpy(),
                                  torch.stack(rb[0][1:3])[:, order].numpy())


@pytest.mark.parametrize("with_rgb", [False, True])
def test_rounding_points_are_the_pallas_kernels(with_rgb):
    """bf16 through the emulation and through the Pallas kernel in
    interpret mode: both sum each conv in f32 and round y, h, up and rgb,
    so they differ only where a reordered f32 sum flips a rounding."""
    rng = np.random.default_rng(7)
    c, n_res = 16, 2
    x = rng.standard_normal((2, 17, 19, c)).astype(np.float32)
    x = x.astype(jnp.bfloat16).astype(np.float32)  # bf16 values
    params = _params(rng, c, n_res, with_rgb)
    xb, *folded = _torch_args(x, *params, dtype=torch.bfloat16)
    ops = trc.lay_out_operands(*folded, torch.bfloat16)
    rounded = emulate(xb, ops, True, round_bf16=True)
    exact = emulate(xb, ops, True, round_bf16=False)

    rb, up_k, up_s, up_b, rgb = params
    bf = jnp.bfloat16
    pallas = jrc.resblock_chain_up_fused(
        jnp.asarray(x, bf),
        [tuple(jnp.asarray(a, bf) if a.ndim == 4 else jnp.asarray(a)
               for a in p) for p in rb],
        jnp.asarray(up_k, bf), jnp.asarray(up_s), jnp.asarray(up_b),
        rgb_kernel=None if rgb is None else jnp.asarray(rgb, bf),
        want_h=True, row_chunk=17, interpret=True)
    pallas = pallas if isinstance(pallas, tuple) else (pallas,)
    for r, e, p in zip(rounded, exact, pallas):
        p = torch.from_numpy(np.array(p.astype(jnp.float32)))
        scale = p.abs().max().item()
        err_r = (r - p).abs().max().item()
        err_e = (e - p).abs().max().item()
        assert err_r <= BF16_STEP * scale, (err_r, scale)
        assert err_r < err_e / 2, (err_r, err_e)


def _covered(geo, h, w):
    count = np.zeros((geo.tiles_y * geo.rows, geo.tiles_x * geo.cols), int)
    for ty in range(geo.tiles_y):
        for tx in range(geo.tiles_x):
            y0, x0 = ty * geo.rows, tx * geo.cols
            assert y0 < h and x0 < w  # no tile past its image
            count[y0:y0 + geo.rows, x0:x0 + geo.cols] += 1
    return count[:h, :w]


@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 160), w=st.integers(1, 160),
       mode=st.sampled_from(trc.CONV_MODES + ("head",)),
       dtype=st.sampled_from([torch.bfloat16, torch.float32]))
def test_tile_geometry_covers_each_pixel_once(h, w, mode, dtype):
    geo = trc.tile_geometry(h, w, mode, dtype)
    np.testing.assert_array_equal(_covered(geo, h, w), 1)
    assert all(1 <= d <= 256 for d in geo.box)
    # the inner box dimension spans one row of the swizzle: in bf16 128
    # bytes (64 for the C -> C convs), in f32 64 bytes, the 16-channel K
    # slice of the TF32 products
    row = geo.box[0] * torch.empty((), dtype=dtype).element_size()
    if dtype == torch.float32:
        assert row == 64
    else:
        assert row == (64 if mode == "residual" else 128)
    if mode == "head":
        assert (geo.rows, geo.cols) == trc.HEAD_TILE
        assert geo.box[1:] == (geo.cols + 2, geo.rows + 2, 1)  # with halo
    else:
        # the wgmma row blocks: 2 x 64 rows (N = 2C), 2 x 2 x 64 (N = C)
        assert geo.rows * geo.cols == trc.TILE_PIXELS[mode]
        assert geo.cols in trc.PATCH_COLS
        assert geo.box[1:] == (geo.cols, geo.rows, 1)


PATCH_CASES = [
    ("glu", 64, 64, 2, 64), ("glu", 128, 128, 1, 128), ("glu", 17, 19, 4, 32),
    ("glu", 1, 64, 1, 128), ("glu", 96, 40, 16, 8), ("glu", 24, 100, 8, 16),
    ("residual", 64, 64, 4, 64), ("residual", 128, 128, 2, 128),
    ("up", 17, 19, 8, 32), ("up", 96, 40, 32, 8)]


@pytest.mark.parametrize("mode, h, w, rows, cols", PATCH_CASES)
def test_tile_geometry_picks_the_fewest_patches(mode, h, w, rows, cols):
    geo = trc.tile_geometry(h, w, mode, torch.bfloat16)
    assert (geo.rows, geo.cols) == (rows, cols)
    assert geo.tiles_y == -(-h // rows) and geo.tiles_x == -(-w // cols)


@pytest.mark.parametrize("mode, h, w, rows, cols", PATCH_CASES)
def test_tile_geometry_f32_cuts_the_same_patches(mode, h, w, rows, cols):
    """The f32 kernels cut the patches of the bf16 ones (the same wgmma
    row blocks); their boxes are 16 channels deep (64-byte rows)."""
    geo = trc.tile_geometry(h, w, mode, torch.float32)
    assert (geo.rows, geo.cols) == (rows, cols)
    assert geo.tiles_y == -(-h // rows) and geo.tiles_x == -(-w // cols)
    assert geo.box == (16, cols, rows, 1)
    assert trc.tile_geometry(2 * h, 2 * w, "head", torch.float32).box == (
        16, trc.HEAD_TILE[1] + 2, trc.HEAD_TILE[0] + 2, 1)


def test_tile_geometry_rejects_what_it_cannot_tile():
    with pytest.raises(ValueError, match="unknown tile mode"):
        trc.tile_geometry(8, 8, "rgb", torch.bfloat16)
    with pytest.raises(ValueError, match="h, w >= 1"):
        trc.tile_geometry(0, 8, "glu", torch.bfloat16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        trc.tile_geometry(8, 8, "glu", torch.float16)


def test_fused_stage_follows_in_place_weight_changes(rng):
    """The stage keeps its folded, laid-out operands across calls, and
    lays them out again after a running variance and a conv weight change
    in place."""
    plain, fused, args = _next_stage_pair(rng)
    with torch.no_grad():
        first, _ = fused(*args, return_attn=False)
        ops = fused._tail_ops
        again, _ = fused(*args, return_attn=False)
        assert fused._tail_ops is ops
        for stage in (plain, fused):
            stage.residual[0].bn1.running_var.mul_(1.5)
            stage.upsample.conv.weight.add_(0.05)
        got, _ = fused(*args, return_attn=False)
        want, _ = plain(*args, return_attn=False)
    assert fused._tail_ops is not ops
    np.testing.assert_array_equal(_nhwc(again), _nhwc(first))
    np.testing.assert_allclose(_nhwc(got), _nhwc(want), **CHAIN_TOL)
    assert np.abs(_nhwc(got) - _nhwc(first)).max() > 1e-3
