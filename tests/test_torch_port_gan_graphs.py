"""The GAN step's graph runner (``t2igan_torch.train.graphs``) on the CPU,
through a stub capture backend in place of CUDA graphs.

The stub's capture runs a phase's function once and puts back every
tensor of the train state it changed, moving no version (a CUDA capture
executes nothing), and adds one K1 launch and two BN ``stats`` launches a phase to the
counters, as the kernel wrappers count what a capture records.  Its
replay runs the function again (``run=True``: the step's arithmetic, so
that the graph path can be held to the eager body bit for bit) or does
nothing (``run=False``: the bookkeeping alone, as a replay runs no
Python).  Two-layer CLIP towers, GF_DIM 8, R_NUM 1, two scales, batch 2.
"""

import copy

import numpy as np
import pytest
import torch
import torch.distributed as dist

from t2igan_torch.config import cfg_from_dict
from t2igan_torch.models.clip import ClipConfig, ClipTowerConfig, init_clip_
from t2igan_torch.models.discriminator import init_discriminator_
from t2igan_torch.models.factory import (build_clip, build_discriminators,
                                         build_generator)
from t2igan_torch.models.generator import init_generator_
from t2igan_torch.ops.kernels import LAUNCHES
from t2igan_torch.ops.kernels.batchnorm import BN_LAUNCHES
from t2igan_torch.parallel.mesh import DataMesh
from t2igan_torch.train import graphs
from t2igan_torch.train.checkpoint import gan_payload, restore_gan_payload
from t2igan_torch.train.state import init_gan_state
from t2igan_torch.train.steps import make_gan_step

B, WORDS = 2, 16
CLIP = ClipConfig(vocab_size=512, max_positions=WORDS, eos_token_id=511,
                  projection_dim=32, image_size=32, patch_size=16,
                  region_dim=32, text=ClipTowerConfig(32, 2, 2, 64),
                  vision=ClipTowerConfig(48, 2, 2, 96))
CFG = cfg_from_dict({
    "TREE": {"BASE_SIZE": 64, "BRANCH_NUM": 2},
    "GAN": {"GF_DIM": 8, "DF_DIM": 2, "Z_DIM": 8, "CONDITION_DIM": 16,
            "R_NUM": 1},
    "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": WORDS},
    "TRAIN": {"BATCH_SIZE": B}})
# The text tower, G's forwards, a D update a scale, G's loss, G's
# backward, Adam and the EMA.
PHASES = 1 + 1 + CFG.TREE.BRANCH_NUM + 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's torch ops on one thread, beside the other test
    processes (ROADMAP F26)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def counters():
    for c in (graphs.GAN_GRAPHS, LAUNCHES, BN_LAUNCHES):
        c.clear()
    yield
    for c in (graphs.GAN_GRAPHS, LAUNCHES, BN_LAUNCHES):
        c.clear()


def _setup(seed=0):
    """CLIP, a train state (Adam) and its step, all seeded."""
    rng = torch.Generator().manual_seed(seed)
    clip = init_clip_(build_clip(CLIP), rng).requires_grad_(False)
    gen = init_generator_(build_generator(CFG), rng).train()
    ds = [init_discriminator_(d, rng).train()
          for d in build_discriminators(CFG)]
    return clip, init_gan_state(CFG, gen, ds), make_gan_step(CFG, clip)


def _batch(seed, b=B):
    rng = np.random.default_rng(seed)

    def captions():
        ids = rng.integers(1, 400, (b, WORDS)).astype(np.int32)
        ids[:, 0], ids[:, -1] = 510, 511
        return ids, np.ones_like(ids)

    (ids, mask), (ids2, mask2) = captions(), captions()
    return {"images": [rng.standard_normal((b, s, s, 3)).astype(np.float32)
                       * 0.3 for s in CFG.branch_sizes],
            "ids": ids, "mask": mask, "ids_2": ids2, "mask_2": mask2,
            "class_ids": np.arange(b, dtype=np.int32)}


def _state_tensors(state):
    """Every tensor the step updates in place: the modules' parameters and
    buffers and the optimizers' state."""
    out = [t for m in (state.gen, state.gen_ema, *state.ds)
           for t in (*m.parameters(), *m.buffers())]
    for opt in (state.g_opt, *state.d_opts):
        out += [v for st in opt.state.values() for v in st.values()
                if torch.is_tensor(v)]
    return out


def stub(state, run=True):
    """A capture backend for ``state``'s step on the CPU (the module's
    docstring)."""

    class Stub:
        captures = []

        @staticmethod
        def prepare(opt, device):
            del opt, device

        def capture(self, fn):
            saved = [t.detach().clone() for t in _state_tensors(state)]
            fn()
            # Through .data, which moves no version: a capture leaves the
            # autograd graph it recorded valid.
            for t, s in zip(_state_tensors(state), saved):
                t.data.copy_(s)
            LAUNCHES["memory_read_fwd"] += 1
            BN_LAUNCHES["stats"] += 2
            Stub.captures.append(fn)
            return fn if run else (lambda: None)

    return Stub


@pytest.fixture
def on_stub(monkeypatch):
    """``install(state, run)``: the stub as every device's backend."""

    def install(state, run=True):
        backend = stub(state, run)
        monkeypatch.setattr(graphs, "backend_for", lambda device: backend)
        return backend

    return install


def _steps(step, state, batches, seed=3):
    noise = torch.Generator().manual_seed(seed)
    return [{k: v.clone() for k, v in step(state, b, generator=noise)
             .items()} for b in batches]


def test_one_capture_a_shape_then_replays_equal_to_the_eager_body(on_stub):
    """The first call runs eagerly, the second captures (its own step
    replayed), the rest replay; with replays that rerun the phases, every
    metric and every tensor of the state equals the eager body's, bit for
    bit."""
    _, state, step = _setup()
    backend = on_stub(state)
    batches = [_batch(s) for s in range(4)]
    seen = []
    noise = torch.Generator().manual_seed(3)
    graph_metrics = []
    for b in batches:
        graph_metrics.append({k: v.clone() for k, v in step(
            state, b, generator=noise).items()})
        seen.append(dict(graphs.GAN_GRAPHS))
    assert seen == [{"eager": 1}, {"eager": 1, "capture": 1, "replay": 1},
                    {"eager": 1, "capture": 1, "replay": 2},
                    {"eager": 1, "capture": 1, "replay": 3}]
    assert len(backend.captures) == PHASES
    assert step.graphs.captured is not None and state.step == 4

    _, ref_state, ref_step = _setup()
    ref_metrics = _steps(ref_step.eager, ref_state, batches)
    assert ref_state.step == 4
    for got, want in zip(graph_metrics, ref_metrics):
        assert list(got) == list(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    for got, want in zip(_state_tensors(state), _state_tensors(ref_state)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("sizes, want", [
    # Captured on the second call; another shape, after, runs eagerly.
    ((2, 2, 1, 1, 2, 1, 2), {"eager": 4, "capture": 1, "replay": 3}),
    # The first shape seen once only: the second is captured.
    ((1, 2, 2, 2, 1, 2), {"eager": 3, "capture": 1, "replay": 3}),
])
def test_another_shape_runs_eagerly_and_keeps_the_capture(on_stub, sizes,
                                                          want):
    """One capture: a call whose batch differs from the captured shapes
    runs the eager body, and the capture stands for the next call of its
    own shape."""
    _, state, step = _setup()
    on_stub(state, run=False)
    noise = torch.Generator().manual_seed(3)
    captured = []
    for b in sizes:
        step(state, _batch(b, b), generator=noise)
        captured.append(step.graphs.captured)
    first = next(c for c in captured if c is not None)
    assert all(c is first for c in captured[captured.index(first):])
    assert first.static["ids"].shape[0] == sizes[-1]
    assert dict(graphs.GAN_GRAPHS) == want


def test_given_noise_replays_the_capture_of_drawn_noise(on_stub):
    """Noise given by the caller and noise drawn from its generator are
    copied into the same static inputs: one capture serves both, and the
    replays equal the eager body on each."""
    batches = [_batch(s) for s in range(4)]
    given = torch.Generator().manual_seed(7)
    zs = [(torch.randn(B, CFG.GAN.Z_DIM, generator=given),
           torch.randn(B, CFG.GAN.CONDITION_DIM, generator=given),
           torch.randn(B, CFG.GAN.CONDITION_DIM, generator=given))
          for _ in batches]

    def run(fn, state):
        noise = torch.Generator().manual_seed(3)
        return [{k: v.clone() for k, v in (
            fn(state, b, generator=noise) if i % 2 == 0
            else fn(state, b, *zs[i])).items()}
            for i, b in enumerate(batches)]

    _, state, step = _setup()
    on_stub(state)
    got = run(step, state)
    assert dict(graphs.GAN_GRAPHS) == {"eager": 1, "capture": 1,
                                       "replay": 3}
    _, ref_state, ref_step = _setup()
    want = run(ref_step.eager, ref_state)
    for g, w in zip(got, want):
        assert all(torch.equal(g[k], w[k]) for k in w)


def test_the_cpu_runs_the_eager_body():
    """Without a capture backend (the CPU) every step runs eagerly and
    nothing is captured."""
    _, state, step = _setup()
    noise = torch.Generator().manual_seed(3)
    for s in range(3):
        step(state, _batch(s), generator=noise)
    assert dict(graphs.GAN_GRAPHS) == {"eager": 3}
    assert step.graphs.captured is None


def test_a_mesh_with_a_group_runs_the_eager_body(on_stub, tmp_path):
    """Under a mesh with a process group (one gloo rank here) the step runs
    eagerly, whatever the backend."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        clip, state, _ = _setup()
        mesh = DataMesh(group=dist.group.WORLD, backend="gloo")
        step = make_gan_step(CFG, clip, mesh=mesh)
        backend = on_stub(state)
        noise = torch.Generator().manual_seed(3)
        for s in range(3):
            step(state, _batch(s), generator=noise)
    finally:
        dist.destroy_process_group()
    assert dict(graphs.GAN_GRAPHS) == {"eager": 3}
    assert not backend.captures and step.graphs.captured is None


def test_launch_counts_advance_with_each_replay_not_at_capture(on_stub):
    _, state, step = _setup()
    on_stub(state, run=False)
    noise = torch.Generator().manual_seed(3)
    counts = []
    for s in range(4):
        step(state, _batch(s), generator=noise)
        counts.append((LAUNCHES["memory_read_fwd"], BN_LAUNCHES["stats"]))
    # The eager step launches nothing on the CPU; the capture's step and
    # each later one add what the capture recorded.
    assert counts == [(0, 0)] + [(n * PHASES, 2 * n * PHASES)
                                 for n in (1, 2, 3)]


def test_a_replayed_step_moves_the_versions_of_g_and_its_ema(on_stub):
    """A replay updates G and the EMA G in place without any Python op, so
    the runner moves their versions: the fused tail's operand cache keys
    on them."""
    _, state, step = _setup()
    on_stub(state, run=False)
    noise = torch.Generator().manual_seed(3)
    for s in range(2):
        step(state, _batch(s), generator=noise)
    tensors = [t for m in (state.gen_ema, state.gen)
               for t in (*m.parameters(), *m.buffers())]
    before = [t._version for t in tensors]
    step(state, _batch(2), generator=noise)
    assert graphs.GAN_GRAPHS["replay"] == 2
    assert all(t._version > v for t, v in zip(tensors, before))


def test_the_metrics_do_not_alias_the_graphs_outputs(on_stub):
    """A replay rewrites the graphs' outputs in place (here: the same
    tensors every step), so each step returns copies of its own."""
    _, state, step = _setup()
    on_stub(state, run=False)
    noise = torch.Generator().manual_seed(3)
    out = [step(state, _batch(s), generator=noise) for s in range(4)]
    a, b = out[2], out[3]
    assert list(a) == list(b)
    assert all(b[k].untyped_storage().data_ptr()
               != a[k].untyped_storage().data_ptr() for k in b)


@pytest.mark.parametrize("how", ["rebind", "to", "restore"])
def test_a_rebound_tensor_drops_the_graphs(on_stub, how):
    """Rebinding a parameter's data, ``.to()`` a new memory format and
    restoring a checkpoint (the optimizers' ``load_state_dict``) each drop
    the captures: the next call runs eagerly, the one after captures."""
    _, state, step = _setup()
    on_stub(state, run=False)
    noise = torch.Generator().manual_seed(3)
    for s in range(3):
        step(state, _batch(s), generator=noise)
    assert dict(graphs.GAN_GRAPHS) == {"eager": 1, "capture": 1,
                                       "replay": 2}
    if how == "rebind":
        w = state.ds[0].cond_head.joint.conv.weight
        w.data = w.data.clone()
    elif how == "to":
        state.gen.to(memory_format=torch.channels_last)
    else:
        restore_gan_payload(state, copy.deepcopy(gan_payload(
            state, 0, noise, 0, None)), noise)
    for s in range(3, 6):
        step(state, _batch(s), generator=noise)
    assert dict(graphs.GAN_GRAPHS) == {"eager": 2, "capture": 2,
                                       "replay": 4}
    assert step.graphs.captured is not None


def test_untouched_state_keeps_the_graphs(on_stub):
    """Loading weights in place (``load_state_dict`` of a module) and
    reading the state keep the captures."""
    _, state, step = _setup()
    on_stub(state, run=False)
    noise = torch.Generator().manual_seed(3)
    for s in range(2):
        step(state, _batch(s), generator=noise)
    state.gen_ema.load_state_dict(state.gen.state_dict())
    state.g_opt.state_dict()
    step(state, _batch(2), generator=noise)
    assert dict(graphs.GAN_GRAPHS) == {"eager": 1, "capture": 1,
                                       "replay": 2}


def test_a_capturable_adam_restores_off_the_card():
    """A checkpoint whose Adam groups the card's graphs made capturable
    restores into a CPU state, whose Adam then steps."""
    _, state, step = _setup()
    noise = torch.Generator().manual_seed(3)
    step(state, _batch(0), generator=noise)
    payload = copy.deepcopy(gan_payload(state, 0, noise, 0, None))
    for sd in (payload["g_opt"], *payload["d_opts"]):
        for group in sd["param_groups"]:
            group["capturable"] = True
    restore_gan_payload(state, payload, noise)
    assert not any(g["capturable"] for o in (state.g_opt, *state.d_opts)
                   for g in o.param_groups)
    metrics = step(state, _batch(1), generator=noise)
    assert np.isfinite(float(metrics["g_loss"]))
