"""The legacy encoders of the port (``t2igan_torch/models/legacy.py``)
against the JAX package's (``t2igan/models/legacy.py``) on the CPU, with
the JAX weights bridged by ``t2igan_torch.models.convert``.

Small widths (a 50-word vocabulary, 16 inputs, 24 hidden, T = 8; the
Inception trunk at 139 px, where ``mixed6e`` is 7x7).  Bounds in f32:
``RnnEncoder`` words and sentence 1e-5 over ragged lengths 0..T (length 0
pinned to the JAX value), through the port's loader and through a
reference-format state dict read by the JAX converter;
``GlobalAttentionText`` 1e-5, masked and unmasked; ``CnnEncoder`` 1e-4
(two packages' convolutions through the Inception trunk), and its trunk
gets no gradient.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2igan.models import convert as jconvert
from t2igan.models import legacy as jlegacy
from t2igan_torch.models.convert import (load_jax_cnn_encoder,
                                         load_jax_global_attention_text,
                                         load_jax_rnn_encoder)
from t2igan_torch.models.legacy import (CnnEncoder, GlobalAttentionText,
                                        RnnEncoder)

NTOKEN, NINPUT, NHIDDEN, T = 50, 16, 24, 8
LENGTHS = [T, 5, 1, 0, 3, 7, 2, 6, 4, 0]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _captions(seed, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    caps = rng.integers(1, NTOKEN, (len(lengths), T)).astype(np.int32)
    for i, n in enumerate(lengths):
        caps[i, n:] = 0
    return caps, np.asarray(lengths, np.int32)


@functools.lru_cache(maxsize=None)
def _jax_rnn(rnn_type, seed=0):
    model = jlegacy.RnnEncoder(ntoken=NTOKEN, ninput=NINPUT, nhidden=NHIDDEN,
                               rnn_type=rnn_type)
    caps, lens = _captions(0)
    v = model.init(jax.random.PRNGKey(seed), jnp.asarray(caps),
                   jnp.asarray(lens))
    # Random biases: flax initialises them to 0, which would hide a
    # misplaced one.
    rng = np.random.default_rng(seed + 1)
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: (a + rng.normal(0, 0.3, a.shape).astype(np.float32)
                      if p[-1].key == "bias" else a), _np(v))
    return model, v


def _port_rnn(rnn_type, variables):
    return load_jax_rnn_encoder(
        RnnEncoder(NTOKEN, NINPUT, NHIDDEN, rnn_type), variables).eval()


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("rnn_type", ["LSTM", "GRU"])
def test_rnn_encoder_matches_jax(rnn_type, seed):
    model, v = _jax_rnn(rnn_type)
    caps, lens = _captions(seed)
    jw, js = model.apply(v, jnp.asarray(caps), jnp.asarray(lens))
    with torch.no_grad():
        pw, ps = _port_rnn(rnn_type, v)(torch.from_numpy(caps),
                                        torch.from_numpy(lens))
    assert pw.shape == (len(LENGTHS), T, NHIDDEN)
    assert ps.shape == (len(LENGTHS), NHIDDEN)
    _close(pw, jw, 1e-5)
    _close(ps, js, 1e-5)
    for i, n in enumerate(lens):
        assert not pw[i, n:].any()


@pytest.mark.parametrize("rnn_type", ["LSTM", "GRU"])
def test_rnn_encoder_length_zero_is_the_jax_value(rnn_type):
    """The JAX scans give a length-0 row zero word states and a sentence
    of the forward state after the first token (the length-1 row's) and
    the backward state over the whole row (the length-T row's)."""
    model, v = _jax_rnn(rnn_type)
    caps, _ = _captions(7, [T])
    row = np.repeat(caps, 3, axis=0)
    lens = np.asarray([0, 1, T], np.int32)
    jw, js = model.apply(v, jnp.asarray(row), jnp.asarray(lens))
    with torch.no_grad():
        pw, ps = _port_rnn(rnn_type, v)(torch.from_numpy(row),
                                        torch.from_numpy(lens))
    _close(ps, js, 1e-5)
    h = NHIDDEN // 2
    assert not pw[0].any() and not np.asarray(jw[0]).any()
    _close(ps[0, :h], ps[1, :h], 1e-6)  # other batch makeups: 1 ulp
    _close(ps[0, h:], ps[2, h:], 1e-6)


@pytest.mark.parametrize("rnn_type", ["LSTM", "GRU"])
def test_reference_state_dict_through_the_jax_converter(rnn_type):
    """A reference-format ``RNN_ENCODER`` state dict (the port's own, with
    random biases on both sides) read by the JAX package's
    ``convert_torch_rnn_encoder_state`` encodes as the port does."""
    torch.manual_seed(0)
    port = RnnEncoder(NTOKEN, NINPUT, NHIDDEN, rnn_type).eval()
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    assert {"encoder.weight", "rnn.weight_ih_l0", "rnn.bias_hh_l0_reverse"} \
        <= set(sd)
    jv = jconvert.convert_torch_rnn_encoder_state(sd, rnn_type)
    model = jlegacy.RnnEncoder(ntoken=NTOKEN, ninput=NINPUT, nhidden=NHIDDEN,
                               rnn_type=rnn_type)
    caps, lens = _captions(11)
    jw, js = model.apply(jv, jnp.asarray(caps), jnp.asarray(lens))
    with torch.no_grad():
        pw, ps = port(torch.from_numpy(caps), torch.from_numpy(lens))
    _close(pw, jw, 1e-5)
    _close(ps, js, 1e-5)


def test_rnn_encoder_dropout_only_in_train():
    _, v = _jax_rnn("LSTM")
    port = _port_rnn("LSTM", v)
    caps, lens = _captions(2)
    args = torch.from_numpy(caps), torch.from_numpy(lens)
    with torch.no_grad():
        a, b = port(*args), port(*args)
        torch.manual_seed(0)
        c = port(*args, train=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.allclose(a[1], c[1])


def test_rnn_loaders_refuse_the_other_cell():
    _, v = _jax_rnn("GRU")
    with pytest.raises(KeyError):
        _port_rnn("LSTM", v)
    with pytest.raises(ValueError):
        RnnEncoder(NTOKEN, rnn_type="RNN")


@pytest.mark.parametrize("masked", [False, True])
def test_global_attention_text_matches_jax(masked):
    rng = np.random.default_rng(1)
    inp = rng.standard_normal((3, 5, 6, 8)).astype(np.float32)
    ctx = rng.standard_normal((3, 7, 12)).astype(np.float32)
    pad = np.zeros((3, 7), bool)
    pad[0, 4:] = pad[2, 1:] = True
    model = jlegacy.GlobalAttentionText(idf=8)
    v = _np(model.init(jax.random.PRNGKey(0), jnp.asarray(inp),
                       jnp.asarray(ctx)))
    mask = pad if masked else None
    want = model.apply(v, jnp.asarray(inp), jnp.asarray(ctx),
                       None if mask is None else jnp.asarray(mask))
    port = load_jax_global_attention_text(GlobalAttentionText(8, 12), v)
    with torch.no_grad():
        got = port(torch.from_numpy(inp), torch.from_numpy(ctx),
                   None if mask is None else torch.from_numpy(mask))
    assert got.shape == (3, 7, 8)
    _close(got, want, 1e-5)


def _random_variables(shapes, rng):
    """Seeded variables of the given shapes, by leaf name: He-normal
    kernels, BN scale and variance near 1, small biases and means."""
    def leaf(path, sd):
        name, shape = path[-1].key, sd.shape
        if name == "kernel":
            std = np.sqrt(2.0 / np.prod(shape[:-1]))
            return rng.normal(0.0, std, shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        return rng.normal(0.0, 0.1, shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _cnn():
    """The JAX CnnEncoder on seeded variables (shapes from ``eval_shape``:
    its ``init`` takes half a minute on the CPU), applied eagerly."""
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (2, 139, 139, 3)).astype(np.float32)
    model = jlegacy.CnnEncoder(nef=32)
    v = _random_variables(jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                         jnp.asarray(x)), rng)
    feats, code = model.apply(v, jnp.asarray(x))
    port = load_jax_cnn_encoder(CnnEncoder(nef=32), v).eval()
    return x, v, np.asarray(feats), np.asarray(code), port


def test_cnn_encoder_matches_jax():
    x, _, jf, jc, port = _cnn()
    with torch.no_grad():
        feats, code = port(torch.from_numpy(x))
    assert feats.shape == jf.shape == (2, 7, 7, 32)
    assert code.shape == jc.shape == (2, 32)
    _close(feats, jf, 1e-4)
    _close(code, jc, 1e-4)


def test_cnn_encoder_trunk_gets_no_gradient():
    x, _, _, _, port = _cnn()
    port.train()
    assert not port.inception.training  # the trunk stays in eval mode
    port.zero_grad()
    feats, code = port(torch.from_numpy(x))
    (feats.square().mean() + code.square().mean()).backward()
    assert all(p.grad is None for p in port.inception.parameters())
    assert port.emb_features.weight.grad.abs().sum() > 0
    assert port.emb_cnn_code.bias.grad.abs().sum() > 0
    port.eval()


def test_cnn_loader_refuses_extra_variables():
    _, v, _, _, _ = _cnn()
    bad = dict(v, params=dict(v["params"], extra={"kernel": np.zeros(1)}))
    with pytest.raises(ValueError, match="extra"):
        load_jax_cnn_encoder(CnnEncoder(nef=32), bad)
