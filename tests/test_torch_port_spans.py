"""The port's spans (``t2igan_torch.utils.profiling.span``) on the CPU at
tiny widths: a GAN step, a fused-tail sampler call and a rank call each
emit their ``t2igan.*`` spans the stated number of times, nested as
stated, under ``torch.profiler``; none is entered with no profiler on;
outputs are bitwise the same with the profiler on and off; and every
span that ``BENCHMARK.json``'s per-layer metrics read is emitted here, so
a renamed span fails a test instead of leaving a metric unread.

A generator of three sizes (BRANCH_NUM 3: two refinement stages), GF_DIM
8, R_NUM 1, batch 2, two-layer CLIP towers."""

import collections
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.spans import READERS, span_of
from t2igan_torch.config import cfg_from_dict
from t2igan_torch.evaluation.rprecision import make_rank_fn
from t2igan_torch.models.clip import ClipConfig, ClipTowerConfig, init_clip_
from t2igan_torch.models.discriminator import init_discriminator_
from t2igan_torch.models.factory import (build_clip, build_discriminators,
                                         build_generator)
from t2igan_torch.models.generator import init_generator_
from t2igan_torch.train.state import init_gan_state
from t2igan_torch.train.steps import make_gan_step, make_sampler

REPO = Path(__file__).resolve().parents[1]
B, WORDS, N_MIS = 2, 16, 3
CLIP = ClipConfig(vocab_size=512, max_positions=WORDS, eos_token_id=511,
                  projection_dim=32, image_size=32, patch_size=16,
                  region_dim=32, text=ClipTowerConfig(32, 2, 2, 64),
                  vision=ClipTowerConfig(48, 2, 2, 96))
CFG = cfg_from_dict({
    "TREE": {"BASE_SIZE": 64, "BRANCH_NUM": 3},
    "GAN": {"GF_DIM": 8, "DF_DIM": 2, "Z_DIM": 8, "CONDITION_DIM": 16,
            "R_NUM": 1, "FUSED_TAIL": True},
    "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": WORDS},
    "TRAIN": {"BATCH_SIZE": B}})
STAGES = CFG.TREE.BRANCH_NUM - 1

# Spans a call emits, by path (fused-tail sampler: operands already laid
# out), and the span each one lies inside.
EXPECTED = {
    "gan": {"t2igan.gan.g_forward": 1,
            "t2igan.gan.d_update": CFG.TREE.BRANCH_NUM,
            "t2igan.gan.g_loss": 1, "t2igan.gan.g_backward": 1,
            "t2igan.gan.g_step": 1, "t2igan.g.stage": 2 * STAGES},
    "sampler": {"t2igan.sampler.text": 1, "t2igan.sampler.generator": 1,
                "t2igan.g.stage": STAGES, "t2igan.kernel.reschain": STAGES},
    "rank": {"t2igan.rank.put": 1, "t2igan.rank.image": 1,
             "t2igan.rank.text": 1},
}
NESTED = {
    "gan": {"t2igan.g.stage": "t2igan.gan.g_forward"},
    "sampler": {"t2igan.g.stage": "t2igan.sampler.generator",
                "t2igan.kernel.reschain": "t2igan.g.stage"},
    "rank": {},
}
PATHS = sorted(EXPECTED)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's torch ops on one thread, beside the other test
    processes (ROADMAP F26)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _captions(rng, *shape):
    ids = rng.integers(1, 400, (*shape, WORDS)).astype(np.int32)
    mask = np.ones_like(ids)
    ids[..., 0], ids[..., -1] = 510, 511
    return ids, mask


def _models():
    """CLIP, a train-mode G, its D and a fused-tail eval G, all seeded."""
    rng = torch.Generator().manual_seed(0)
    clip = init_clip_(build_clip(CLIP), rng).requires_grad_(False)
    gen = init_generator_(build_generator(CFG), rng).train()
    ds = [init_discriminator_(d, rng).train()
          for d in build_discriminators(CFG)]
    served = copy.deepcopy(gen).eval().requires_grad_(False)
    return clip, gen, ds, served


def _inputs():
    rng = np.random.default_rng(1)
    ids, mask = _captions(rng, B)
    ids2, mask2 = _captions(rng, B)
    mis_ids, mis_mask = _captions(rng, B, N_MIS)
    return {
        "batch": {"images": [rng.standard_normal((B, s, s, 3)).astype(
                      np.float32) * 0.3 for s in CFG.branch_sizes],
                  "ids": ids, "mask": mask, "ids_2": ids2, "mask_2": mask2,
                  "class_ids": np.arange(B, dtype=np.int32)},
        "z": rng.standard_normal((B, CFG.GAN.Z_DIM)).astype(np.float32),
        "eps": rng.standard_normal((B, CFG.GAN.CONDITION_DIM)).astype(
            np.float32),
        "eps2": rng.standard_normal((B, CFG.GAN.CONDITION_DIM)).astype(
            np.float32),
        "images": rng.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32),
        "mis": (mis_ids, mis_mask),
    }


def _calls():
    """One call a path on fresh, seeded models: each returns its outputs
    (the GAN step its metrics and G's parameters after the step)."""
    clip, gen, ds, served = _models()
    x = _inputs()
    state = init_gan_state(CFG, gen, ds)
    step = make_gan_step(CFG, clip)
    sample = make_sampler(CFG, clip, served)
    rank = make_rank_fn(clip)
    b = x["batch"]
    t = torch.as_tensor

    def gan():
        metrics = step(state, b, z=t(x["z"]), eps1=t(x["eps"]),
                       eps2=t(x["eps2"]))
        return [*metrics.values(), *gen.parameters(), *gen.buffers()]

    def sampler():
        return sample(b["ids"], b["mask"], x["z"], x["eps"])

    def ranked():
        return rank(x["images"], b["ids"], b["mask"], *x["mis"])

    return {"gan": gan, "sampler": sampler, "rank": ranked}


def _traced(fn):
    """``fn()`` under the CPU profiler: its result and its ``t2igan.*``
    spans as (name, start, end, thread)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name, e.time_range.start, e.time_range.end, e.thread)
             for e in prof.events() if e.name.startswith("t2igan.")]
    return out, spans


@pytest.fixture(scope="module")
def traced():
    """Each path's spans on fresh models; the sampler twice, its first
    call laying out the fused tail's operands."""
    calls = _calls()
    out = {"sampler_first": _traced(calls["sampler"])}
    for path in PATHS:
        out[path] = _traced(calls[path])
    return out


def _counts(spans):
    return collections.Counter(name for name, *_ in spans)


@pytest.mark.parametrize("path", PATHS)
def test_a_call_emits_each_span_as_often_as_stated(traced, path):
    _, spans = traced[path]
    counts = _counts(spans)
    want = dict(EXPECTED[path], **({"t2igan.kernel.layout": 0}
                                   if path == "sampler" else {}))
    assert {k: counts.get(k, 0) for k in want} == want
    assert set(counts) == {k for k, v in want.items() if v}


@pytest.mark.parametrize("path", PATHS)
def test_spans_nest_as_stated(traced, path):
    _, spans = traced[path]
    for inner, outer in NESTED[path].items():
        outers = [s for s in spans if s[0] == outer]
        for name, start, end, thread in spans:
            if name == inner:
                assert any(o[1] <= start and end <= o[2] and o[3] == thread
                           for o in outers), (inner, outer)


def test_layout_span_once_a_stage_on_the_first_call_only(traced):
    first = traced["sampler_first"][1]
    assert _counts(first)["t2igan.kernel.layout"] == STAGES
    assert _counts(traced["sampler"][1])["t2igan.kernel.layout"] == 0
    stages = [s for s in first if s[0] == "t2igan.g.stage"]
    for name, start, end, _ in first:
        if name == "t2igan.kernel.layout":
            assert any(s[1] <= start and end <= s[2] for s in stages)


@pytest.mark.parametrize("path", PATHS)
def test_no_record_function_entered_without_a_profiler(monkeypatch, path):
    """With no profiler the spans are the shared no-op context: no
    ``record_function`` of the program is entered (torch's own, such as
    ``Optimizer.step``'s, are)."""
    calls = _calls()
    calls["sampler"]()  # operands laid out
    entered = []
    cls = torch.autograd.profiler.record_function
    enter = cls.__enter__

    def counting(self):
        entered.append(self.name)
        return enter(self)

    monkeypatch.setattr(cls, "__enter__", counting)
    calls[path]()
    assert not [n for n in entered if n.startswith("t2igan.")]
    _traced(calls[path])  # the patch sees the spans once a profiler runs
    assert sum(n.startswith("t2igan.") for n in entered) == sum(
        EXPECTED[path].values())


@pytest.mark.parametrize("path", PATHS)
def test_outputs_are_bitwise_the_same_with_the_profiler_on(traced, path):
    on = traced[path][0]
    calls = _calls()
    calls["sampler"]()
    off = calls[path]()
    on, off = (list(v) if isinstance(v, (list, tuple)) else [v]
               for v in (on, off))
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_every_span_the_benchmark_reads_is_emitted(traced):
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    read = {span_of(m["name"]) for m in bench["per_layer"]
            if m["name"].split(".", 1)[0] in READERS}
    assert read
    emitted = set().union(*(_counts(s) for _, s in traced.values()))
    assert read <= emitted, sorted(read - emitted)
