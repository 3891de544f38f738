"""The port's fused eval stage tail (K3) on the CPU: its plain version
against the JAX package's XLA reference and its Pallas kernel in interpret
mode, the subpixel phase kernels, the wrapper's argument checks, and the
fused generator (``GAN.FUSED_TAIL``) against the port's module chain and
the JAX ``GNet(fused_tail=True)``.

Tolerances, f32: 1e-4 against the XLA reference (the same folded math,
sums in another order); 1e-3 against the Pallas kernel, the JAX package's
own bound between its kernel and that reference
(``tests/test_reschain_fused.py``); 1e-5 between the port's fused and
module-chain paths (folded BN, the same convs); 1e-4 against the JAX
``GNet``, the bound of ``tests/test_torch_port_generator.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2igan.models import generator as jgen
from t2igan.ops.pallas import reschain as jrc
from t2igan_torch.models import generator as tgen
from t2igan_torch.models.convert import load_jax_generator
from t2igan_torch.ops.kernels import LAUNCHES
from t2igan_torch.ops.kernels import reschain as trc
from test_torch_port_generator import (B, SMALL, _gnet_variables, _inputs,
                                       _nchw, _nhwc, _randomize_bn)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's torch ops on one thread: beside the other test
    processes a process that takes every core slows down many times over
    (ROADMAP F26)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REF_TOL = dict(rtol=1e-4, atol=1e-4)
PALLAS_TOL = dict(rtol=1e-3, atol=1e-3)
CHAIN_TOL = dict(rtol=1e-5, atol=1e-5)

# The cases of tests/test_reschain_fused.py (n_res, with_rgb, want_h,
# row chunks of the Pallas grid).
CASES = [(1, False, True, 1), (2, False, True, 2), (2, True, True, 2),
         (2, True, False, 4), (3, False, True, 1)]


@pytest.fixture(autouse=True)
def _no_env_overrides(monkeypatch):
    for name in ("T2IGAN_UPBLOCK", "T2IGAN_PHASED_TAIL", "T2IGAN_RESCHAIN",
                 "T2IGAN_MEMREAD"):
        monkeypatch.delenv(name, raising=False)


def _params(rng, c, n_res, with_rgb):
    """Weights as tests/test_reschain_fused.py draws them, numpy f32."""
    def t(*shape, scale=0.3):
        return rng.standard_normal(shape).astype(np.float32) * scale

    rb = [(t(3, 3, c, 2 * c), t(2 * c) + 1.0, t(2 * c),
           t(3, 3, c, c), t(c) + 1.0, t(c)) for _ in range(n_res)]
    rgb = t(3, 3, c // 2, 3) if with_rgb else None
    return rb, t(3, 3, c, c), t(c) + 1.0, t(c), rgb


def _run(fn, to, x, rb, up_k, up_s, up_b, rgb, want_h, **kw):
    out = fn(to(x), [tuple(to(a) for a in p) for p in rb], to(up_k),
             to(up_s), to(up_b),
             rgb_kernel=None if rgb is None else to(rgb), want_h=want_h, **kw)
    outs = out if isinstance(out, tuple) else (out,)
    return [np.asarray(o) for o in outs]


def _torch_outputs(x, rb, up_k, up_s, up_b, rgb, want_h):
    return _run(trc.resblock_chain_up_plain, torch.from_numpy, x, rb, up_k,
                up_s, up_b, rgb, want_h)


@pytest.mark.parametrize("n_res,with_rgb,want_h,chunks", CASES)
def test_plain_matches_xla_reference(n_res, with_rgb, want_h, chunks):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    args = (x,) + _params(rng, 8, n_res, with_rgb) + (want_h,)
    got = _torch_outputs(*args)
    want = _run(jrc.resblock_chain_up_reference, jnp.asarray, *args)
    assert len(got) == len(want) == (2 if with_rgb and want_h else 1)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **REF_TOL)


@pytest.mark.parametrize("n_res,with_rgb,want_h,chunks", CASES)
def test_plain_matches_pallas_interpret(n_res, with_rgb, want_h, chunks):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    args = (x,) + _params(rng, 8, n_res, with_rgb) + (want_h,)
    got = _torch_outputs(*args)
    want = _run(jrc.resblock_chain_up_fused, jnp.asarray, *args,
                row_chunk=8 // chunks, interpret=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **PALLAS_TOL)


@pytest.mark.parametrize("oracle", ["reference", "pallas"])
def test_plain_border_with_exaggerated_shifts(oracle):
    """BN shifts +3 make any missing zero padding at the image border
    unmistakable (tests/test_reschain_fused.py's boundary case)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 8, 8, 8)).astype(np.float32)
    rb, up_k, up_s, up_b, _ = _params(rng, 8, 2, False)
    rb = [(k1, s1, b1 + 3.0, k2, s2, b2 + 3.0)
          for (k1, s1, b1, k2, s2, b2) in rb]
    args = (x, rb, up_k, up_s, up_b, None, True)
    (got,) = _torch_outputs(*args)
    if oracle == "reference":
        (want,) = _run(jrc.resblock_chain_up_reference, jnp.asarray, *args)
        tol = REF_TOL
    else:
        (want,) = _run(jrc.resblock_chain_up_fused, jnp.asarray, *args,
                       row_chunk=4, interpret=True)
        tol = PALLAS_TOL
    for rows in (slice(0, 2), slice(-2, None), slice(None)):
        np.testing.assert_allclose(got[:, rows], want[:, rows], **tol)


def test_phase_kernels_match_exactly(rng):
    k = rng.standard_normal((3, 3, 8, 6)).astype(np.float32)
    got = trc.phase_kernels(torch.from_numpy(k)).numpy()
    want = np.asarray(jrc._phase_kernels(jnp.asarray(k)))
    assert got.shape == (4, 2, 2, 8, 6)
    np.testing.assert_array_equal(got, want)


def test_phase_kernels_are_the_upsample_conv(rng):
    """Each subpixel phase of conv3x3(nearest2x(x)) is a 2x2 conv of the
    zero-padded low-res map by that phase's summed-tap kernel."""
    x = torch.from_numpy(rng.standard_normal((1, 5, 6, 4)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((3, 3, 4, 2)).astype(np.float32))
    nchw = x.permute(0, 3, 1, 2)
    full = torch.nn.functional.conv2d(
        torch.nn.functional.interpolate(nchw, scale_factor=2),
        k.permute(3, 2, 0, 1), padding=1)
    ph = trc.phase_kernels(k)
    padded = torch.nn.functional.pad(nchw, (1, 1, 1, 1))
    for a in (0, 1):
        for b in (0, 1):
            part = torch.nn.functional.conv2d(
                padded[:, :, a:a + 6, b:b + 7],
                ph[2 * a + b].permute(3, 2, 0, 1))
            torch.testing.assert_close(part, full[:, :, a::2, b::2],
                                       rtol=1e-5, atol=1e-5)


def test_cpu_wrapper_is_the_plain_version(rng):
    x = rng.standard_normal((2, 4, 5, 16)).astype(np.float32)
    rb, up_k, up_s, up_b, rgb = _params(rng, 16, 2, True)
    before = LAUNCHES[trc.KERNEL]
    got = _run(trc.resblock_chain_up_fused, torch.from_numpy, x, rb, up_k,
               up_s, up_b, rgb, True)
    want = _torch_outputs(x, rb, up_k, up_s, up_b, rgb, True)
    assert LAUNCHES[trc.KERNEL] == before
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _kernel_args(c=16, n_res=2, with_rgb=True, dtype=torch.float32):
    rb, up_k, up_s, up_b, rgb = _params(np.random.default_rng(0), c, n_res,
                                        with_rgb)
    t = torch.from_numpy
    return dict(x=torch.zeros((2, 4, 4, c), dtype=dtype),
                rb_params=[tuple(t(a) for a in p) for p in rb],
                up_kernel=t(up_k), up_scale=t(up_s), up_shift=t(up_b),
                rgb_kernel=None if rgb is None else t(rgb), want_h=True)


@pytest.mark.parametrize("change, match", [
    (dict(x=torch.zeros((2, 4, 4, 16), dtype=torch.float16)), "f32 or bf16"),
    (dict(x=torch.zeros((2, 4, 4, 16)).permute(0, 2, 1, 3)), "contiguous"),
    (dict(x=torch.zeros((2, 4, 16))), r"\[B, H, W, C\]"),
    (dict(rb_params=[]), "at least one residual block"),
    (dict(rgb_kernel=None, want_h=False), "nothing to compute"),
    (dict(up_kernel=torch.zeros((3, 3, 16, 8))), r"\(3, 3, 16, 16\)"),
    (dict(rgb_kernel=torch.zeros((3, 3, 16, 3))), r"\(3, 3, 8, 3\)"),
    # TMA's rules for the bf16 kernels: a 16-byte aligned base, rows of
    # C and C/2 channels in whole 16-byte units.
    (dict(x=torch.zeros(2 * 4 * 4 * 16 + 1, dtype=torch.bfloat16)[1:]
          .view(2, 4, 4, 16)), "16-byte boundary"),
    (dict(x=torch.zeros((2, 4, 4, 24), dtype=torch.bfloat16)),
     "multiples of 16 bytes"),
    # and for the f32 kernels, which read x and up through TMA too
    (dict(x=torch.zeros(2 * 4 * 4 * 16 + 1)[1:].view(2, 4, 4, 16)),
     "f32 x must start on a 16-byte boundary"),
])
def test_kernel_arg_checks(change, match):
    args = dict(_kernel_args(), **change)
    with pytest.raises(ValueError, match=match):
        trc.check_kernel_args(**args)


@pytest.mark.parametrize("c", [8, 24])
def test_kernel_takes_channels_in_multiples_of_16(c):
    args = _kernel_args(c=c, with_rgb=False)
    with pytest.raises(ValueError, match="multiple of 16"):
        trc.check_kernel_args(**args)
    trc.check_kernel_args(**_kernel_args(c=32))


def test_wrapper_refuses_other_devices():
    args = _kernel_args()
    args["x"] = args["x"].to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        trc.resblock_chain_up_fused(**args)


def test_fold_is_the_eval_module_chain(rng):
    """ResBlock and UpBlock folds through the plain tail equal the
    modules in eval mode (random running statistics)."""
    x = rng.standard_normal((2, 6, 6, 8)).astype(np.float32)
    blocks = []
    for cls, args in ((jgen.ResBlock, dict(features=8)),
                      (jgen.ResBlock, dict(features=8)),
                      (jgen.UpBlock, dict(features=4, variant="naive"))):
        m = cls(**args)
        v = _randomize_bn(jax.jit(functools.partial(m.init, train=False))(
            jax.random.PRNGKey(len(blocks)), x))
        port = tgen.ResBlock(8) if cls is jgen.ResBlock else tgen.UpBlock(8, 4)
        blocks.append(load_jax_generator(port, v))
    h = _nchw(x)
    with torch.no_grad():
        chain = blocks[2](blocks[1](blocks[0](h)))
        fused = trc.resblock_chain_up_plain(
            h.permute(0, 2, 3, 1), [blocks[0].fold(), blocks[1].fold()],
            *blocks[2].fold())
    np.testing.assert_allclose(fused.numpy(), _nhwc(chain), **CHAIN_TOL)


def _next_stage_pair(rng):
    _, _, words, pad, _ = _inputs(rng)
    h = rng.standard_normal((B, 16, 16, 16)).astype(np.float32)
    stage = jgen.NextStageG(ngf=16, nef=24, num_residual=2)
    v = _randomize_bn(jax.jit(functools.partial(stage.init, train=False))(
        jax.random.PRNGKey(0), h, words, pad))
    plain = load_jax_generator(tgen.NextStageG(16, 24, 2), v)
    fused = load_jax_generator(tgen.NextStageG(16, 24, 2, fused_tail=True), v)
    return plain, fused, (_nchw(h), torch.from_numpy(words),
                          torch.from_numpy(pad))


def test_fused_next_stage_matches_module_chain(rng):
    plain, fused, args = _next_stage_pair(rng)
    with torch.no_grad():
        want, want_attn = plain(*args, return_attn=True)
        got, attn = fused(*args, return_attn=True)
    assert got.shape == want.shape == (B, 16, 32, 32)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(got), _nhwc(want), **CHAIN_TOL)
    np.testing.assert_allclose(attn.numpy(), want_attn.numpy(), **CHAIN_TOL)


def test_fused_next_stage_with_rgb_head(rng):
    plain, fused, args = _next_stage_pair(rng)
    head = tgen.GetImageG(16)
    torch.nn.init.normal_(head.conv.weight, 0, 0.1,
                          generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        h, _ = plain(*args, return_attn=False)
        want = head(h)
        got, _ = fused(*args, return_attn=False, rgb_kernel=head.fold())
        with pytest.raises(ValueError, match="fused eval tail only"):
            plain(*args, return_attn=False, rgb_kernel=head.fold())
    assert got.shape == (B, 3, 32, 32)
    np.testing.assert_allclose(_nhwc(got), _nhwc(want), **CHAIN_TOL)


def test_train_mode_ignores_the_flag(rng):
    """In train mode both stages run the module chain with batch
    statistics: equal outputs and equal running-statistics updates."""
    plain, fused, args = _next_stage_pair(rng)
    with torch.no_grad():
        want, _ = plain(*args, return_attn=False, train=True)
        got, _ = fused(*args, return_attn=False, train=True)
    np.testing.assert_array_equal(_nhwc(got), _nhwc(want))
    for (name, a), b in zip(plain.state_dict().items(),
                            fused.state_dict().values()):
        assert torch.equal(a, b), name


def _gnet_images(model, rng, train=False):
    z, sent, words, pad, eps = _inputs(rng)
    with torch.no_grad():
        imgs, _, _, _ = model(torch.from_numpy(z), torch.from_numpy(sent),
                              torch.from_numpy(words), torch.from_numpy(pad),
                              torch.from_numpy(eps), return_attn=False,
                              train=train)
    return [i.numpy() for i in imgs]


def test_fused_gnet_matches_module_chain(rng):
    v = _gnet_variables()
    plain = load_jax_generator(tgen.GNet(**SMALL).eval(), v)
    fused = load_jax_generator(tgen.GNet(**SMALL, fused_tail=True).eval(), v)
    got = _gnet_images(fused, np.random.default_rng(3))
    want = _gnet_images(plain, np.random.default_rng(3))
    assert [g.shape for g in got] == [(B, s, s, 3) for s in (64, 128, 256)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **CHAIN_TOL)


def test_fused_gnet_matches_jax_fused_gnet(rng):
    """Every pyramid image against ``GNet(fused_tail=True)`` in eval mode
    (which takes the folded XLA reference of the fused tail on the CPU)."""
    z, sent, words, pad, eps = _inputs(rng)
    v = _gnet_variables()
    model = jgen.GNet(**SMALL, fused_tail=True)
    apply = jax.jit(functools.partial(model.apply, train=False,
                                      return_attn=False))
    ref, _, _, _ = apply(v, z, sent, words, pad, ca_eps=eps)
    port = load_jax_generator(tgen.GNet(**SMALL, fused_tail=True).eval(), v)
    got = _gnet_images(port, np.random.default_rng(0))
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, np.asarray(b), **REF_TOL)


def test_fused_gnet_train_mode_is_the_module_chain():
    v = _gnet_variables()
    plain = load_jax_generator(tgen.GNet(**SMALL), v).train()
    fused = load_jax_generator(tgen.GNet(**SMALL, fused_tail=True), v).train()
    got = _gnet_images(fused, np.random.default_rng(4), train=True)
    want = _gnet_images(plain, np.random.default_rng(4), train=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)

