"""Train-mode BN with its epilogue (``t2igan_torch.ops.kernels.batchnorm``)
on the CPU: :class:`BatchNormTrain`, running its plain stages, against the
composed ops it replaced in the generator (``BatchNorm.forward(train=True)``
of the parent: f32 mean and ``E[x^2]``, the clamped biased variance, the
flax running update, then ``F.glu`` or the residual add), under autograd.

Compared: the output, the running statistics and the gradients of x,
weight, bias and the residual, for each epilogue on channels_last 4-D and
on 2-D inputs, f32 and bf16, each with a constant channel (the variance's
clamp), and at the fc BN's [16, 32768].  The reference runs in f32 on the
same values (a bf16 input's values, cast): in f32 the bound is 1e-5 of the
largest entry (sums over the rows in another order); in bf16 the fused
path rounds its f32 result once, so an output or dx may differ from the
reference by one bf16 step of the entry besides.

Planted faults must fall outside the bound: the unbiased variance, the
statistics summed in bf16, the GLU's halves swapped.  The kernels' argument
check (plain Python, before any launch) raises on a layout they do not
take."""

import functools

import pytest
import torch
import torch.nn.functional as F

from t2igan_torch.ops.kernels import LAUNCHES
from t2igan_torch.ops.kernels import batchnorm as kbn

EPS = 1e-5
F32_TOL = 1e-5
BF16_STEP = 2.0 ** -7
SHAPES = {"map": (4, 16, 3, 2), "dense": (12, 32), "fc": (16, 32768)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's torch ops on one thread, beside the other test
    processes (ROADMAP F26)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def composed(x, weight, bias, running_mean, running_var, epilogue,
             residual=None):
    """The generator's train-mode BN before the fused op, then its
    epilogue."""
    dims = [d for d in range(x.dim()) if d != 1]
    xf = x.float()
    mean = xf.mean(dims)
    var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
    with torch.no_grad():
        running_mean.copy_(0.9 * running_mean + 0.1 * mean)
        running_var.copy_(0.9 * running_var + 0.1 * var)
    shape = [1, -1] + [1] * (x.dim() - 2)
    mul = torch.rsqrt(var + EPS) * weight
    y = ((xf - mean.view(shape)) * mul.view(shape)
         + bias.view(shape)).to(x.dtype)
    if epilogue == "glu":
        return F.glu(y, dim=1)
    return y if residual is None else residual + y


def _inputs(kind, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    shape = SHAPES[kind]
    c = shape[1]
    per_channel = [1, c] + [1] * (len(shape) - 2)
    x = (torch.randn(shape, generator=g)
         * (torch.rand(per_channel, generator=g) + 0.5)
         + torch.randn(per_channel, generator=g))
    x[:, 1] = 0.1  # a constant channel: E[x^2] - mean^2 is rounding
    fmt = torch.channels_last if len(shape) == 4 else torch.contiguous_format
    x = x.to(dtype).contiguous(memory_format=fmt)
    weight = 1 + 0.1 * torch.randn(c, generator=g)
    bias = 0.1 * torch.randn(c, generator=g)
    res = torch.randn(shape, generator=g).to(dtype).contiguous(
        memory_format=fmt)
    return x, weight, bias, res, g


def _run(fn, kind, dtype, epilogue, seed=0):
    """fn's output, running statistics and gradients (x, weight, bias,
    residual) for the objective sum(out * dout), all in f32; the reference
    (``fn`` None: :func:`composed`) on the same values in f32."""
    x, weight, bias, res, g = _inputs(kind, dtype, seed)
    if fn is None:
        x, res = x.float(), res.float()
    c = x.shape[1]
    x = x.clone().requires_grad_(True)
    weight = weight.clone().requires_grad_(True)
    bias = bias.clone().requires_grad_(True)
    res = (res.clone().requires_grad_(True) if epilogue == "residual"
           else None)
    rm, rv = torch.zeros(c), torch.ones(c)
    if fn is None:
        out = composed(x, weight, bias, rm, rv, epilogue, res)
    else:
        out = fn(x, weight, bias, rm, rv, EPS, glu=epilogue == "glu",
                 residual=res)
    dout = torch.randn(out.shape, generator=g).to(dtype).float()
    inputs = [x, weight, bias] + ([res] if res is not None else [])
    grads = torch.autograd.grad(out, inputs, dout.to(out.dtype))
    names = ["dx", "dweight", "dbias", "dresidual"]
    got = {"out": out, "running_mean": rm, "running_var": rv}
    got.update(zip(names, grads))
    return {k: v.detach().float() for k, v in got.items()}


def _beyond(got, want, dtype):
    """The entries beyond the bound, by quantity."""
    out = {}
    for key, ref in want.items():
        tol = F32_TOL * ref.abs().max()
        if dtype == torch.bfloat16 and key in ("out", "dx"):
            tol = tol + BF16_STEP * ref.abs()
        out[key] = int(((got[key] - ref).abs() > tol).sum())
    return out


@functools.lru_cache(maxsize=None)
def _reference(kind, dtype, epilogue):
    return _run(None, kind, dtype, epilogue)


CASES = [(kind, dtype, epilogue)
         for kind in ("map", "dense")
         for dtype in (torch.float32, torch.bfloat16)
         for epilogue in ("glu", "residual", "none")]
CASES += [("fc", torch.float32, "glu"), ("fc", torch.bfloat16, "glu")]


@pytest.mark.parametrize("kind,dtype,epilogue", CASES)
def test_function_matches_the_composed_ops(kind, dtype, epilogue):
    LAUNCHES.clear()
    kbn.BN_LAUNCHES.clear()
    got = _run(kbn.batch_norm_train, kind, dtype, epilogue)
    want = _reference(kind, dtype, epilogue)
    assert got.keys() == want.keys()
    assert _beyond(got, want, dtype) == dict.fromkeys(want, 0)
    # The plain stages on the CPU: no kernel launched.
    assert not LAUNCHES and not kbn.BN_LAUNCHES


def _unbiased(stats_plain):
    def fault(x, world=1):
        mean, msq = stats_plain(x, world)
        n = x.shape[0]
        return torch.stack([mean, mean * mean
                            + (msq - mean * mean) * n / (n - 1)])
    return fault


def _bf16_sums(stats_plain):
    def fault(x, world=1):
        acc = torch.zeros(2, x.shape[1], dtype=torch.bfloat16)
        for row in x.float():
            acc = acc + torch.stack([row, row * row]).bfloat16()
        return acc.float() / x.shape[0] / world
    return fault


def _swapped(apply_plain):
    def fault(x, stats, weight, bias, rm, rv, eps, glu, residual=None):
        if not glu:
            return apply_plain(x, stats, weight, bias, rm, rv, eps, glu,
                               residual)
        y = apply_plain(x, stats, weight, bias, rm, rv, eps, False).float()
        a, g = y.chunk(2, dim=1)
        return (g * torch.sigmoid(a)).to(x.dtype)
    return fault


FAULTS = {"unbiased_variance": ("forward_stats_plain", _unbiased),
          "statistics_in_bf16": ("forward_stats_plain", _bf16_sums),
          "glu_halves_swapped": ("forward_apply_plain", _swapped)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_fall_outside_the_bound(monkeypatch, fault, dtype):
    name, make = FAULTS[fault]
    monkeypatch.setattr(kbn, name, make(getattr(kbn, name)))
    got = _run(kbn.batch_norm_train, "map", dtype, "glu")
    beyond = _beyond(got, _reference("map", dtype, "glu"), dtype)
    assert beyond["out"] > 0, beyond


def test_the_constant_channel_normalises_to_its_bias():
    """Where the batch variance is 0 the channel's output is its bias (its
    x^ is 0) and its x gets the gradient through the mean alone."""
    got = _run(kbn.batch_norm_train, "map", torch.float32, "none")
    _, _, bias, _, _ = _inputs("map", torch.float32)
    torch.testing.assert_close(got["out"][:, 1],
                               bias[1].expand_as(got["out"][:, 1]),
                               rtol=0, atol=1e-5)
    assert got["running_var"][1].item() == pytest.approx(0.9, abs=1e-7)


@pytest.mark.parametrize("layout", ["nchw", "strided_map", "strided_dense",
                                    "misaligned"])
def test_argument_check_raises_on_a_layout_the_kernels_do_not_take(layout):
    c = 16
    params = [torch.ones(c), torch.zeros(c), torch.zeros(c), torch.ones(c)]
    x = {
        "nchw": torch.randn(2, c, 4, 4),
        "strided_map": torch.randn(2, c, 4, 8).contiguous(
            memory_format=torch.channels_last)[..., ::2],
        "strided_dense": torch.randn(4, 2 * c)[:, ::2],
        "misaligned": torch.randn(4 * c + 1)[1:].view(4, c),
    }[layout]
    with pytest.raises(ValueError, match="batchnorm kernel takes"):
        kbn.check_kernel_args(x, *params)


def test_argument_check_takes_the_layouts_the_generator_gives():
    c = 16
    params = [torch.ones(c), torch.zeros(c), torch.zeros(c), torch.ones(c)]
    m = torch.randn(2, c, 4, 4).contiguous(memory_format=torch.channels_last)
    kbn.check_kernel_args(m, *params, glu=True, residual=m.clone())
    kbn.check_kernel_args(torch.randn(4, c).bfloat16(), *params, glu=True)
    with pytest.raises(ValueError, match="multiple of 16"):
        kbn.check_kernel_args(torch.randn(4, 8).bfloat16(), *[
            p[:8] for p in params], glu=True)
    with pytest.raises(ValueError, match="residual"):
        kbn.check_kernel_args(m, *params, residual=torch.randn(2, c, 4, 4))


@pytest.mark.parametrize("partials", [0, 16, 32])
@pytest.mark.parametrize("rows,cols", [(16, 4096), (1024, 128),
                                       (1 << 20, 16), (1 << 18, 32),
                                       (3, 1), (1000, 24)])
def test_geometry_covers_the_rows_with_a_bounded_grid(rows, cols, partials):
    bc, strips, per_strip = kbn.geometry(rows, cols, partials)
    chunks = -(-cols // bc)
    assert 1 <= bc <= min(cols, kbn.MAX_COLS)
    assert (strips - 1) * per_strip < rows <= strips * per_strip
    assert chunks * strips <= max(chunks, kbn.BLOCKS + chunks)
    # No strip is cut thinner than MIN_ROWS_PER_LANE rows a lane unless it
    # is the only one, and a chunk's last block sums at most PARTIAL_FLOATS
    # partials.
    assert strips == 1 or per_strip >= ((kbn.THREADS // bc)
                                        * kbn.MIN_ROWS_PER_LANE)
    assert strips == 1 or strips * partials * bc <= kbn.PARTIAL_FLOATS
