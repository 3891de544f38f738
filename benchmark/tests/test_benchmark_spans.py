"""The readers of the program's spans (``metrics/device_ms.py``,
``idle_ms.py``, ``host_us.py``, ``count.py``, through
``benchmark.spans``) on hand-built traces, times in microseconds."""

import json
from pathlib import Path

import pytest

from benchmark import harness, spans, spec
from benchmark.trace import Trace

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())


def make_trace(kernels=(), host=(), calls=1, window=(0.0, 100.0)):
    """``kernels``: (start, end, launch time); ``host``: (name, start,
    end[, thread])."""
    device, launch = [], {}
    for i, (s, e, at) in enumerate(kernels):
        device.append({"cat": "kernel", "name": f"k{i}", "ts": s,
                       "dur": e - s, "args": {"correlation": i}})
        launch[i] = at
    ops = [{"name": h[0], "ts": h[1], "dur": h[2] - h[1],
            "tid": h[3] if len(h) > 3 else 1, "cat": "user_annotation"}
           for h in host]
    return Trace(calls=calls, window=window, device_ops=device,
                 host_ops=ops, launch_ts=launch)


def reading(t, calls=None, seconds=None):
    """The untraced window as long as the traced one unless given."""
    calls = t.calls if calls is None else calls
    seconds = t.window_s if seconds is None else seconds
    return harness.Reading(None, None, calls, seconds, t)


def read(metric, r):
    mod = spec.load_module(spec.reader_path(ROOT, metric),
                           "reader_" + metric.replace(".", "_"))
    return mod.read(metric, r)


def test_nested_spans_give_the_gap_to_the_inner_one():
    t = make_trace(kernels=[(0, 10, 0), (70, 100, 5)],
                   host=[("t2igan.a", 0, 100), ("t2igan.a.b", 20, 60)])
    assert spans.idle_us_by_span(t) == {"t2igan.a": 20.0,
                                        "t2igan.a.b": 40.0}
    assert read("idle_ms.x.a.b", reading(t)) == pytest.approx(0.040)
    assert read("idle_ms.x.a", reading(t)) == pytest.approx(0.020)


def test_the_innermost_span_is_the_latest_started_on_any_thread():
    t = make_trace(kernels=[(0, 10, 0), (90, 100, 0)],
                   host=[("t2igan.main", 0, 100, 1),
                         ("t2igan.other", 30, 50, 2),
                         ("aten::copy_", 10, 90, 1)])
    assert spans.idle_us_by_span(t) == {"t2igan.main": 60.0,
                                        "t2igan.other": 20.0}


def test_a_gap_across_a_span_boundary_is_split():
    t = make_trace(kernels=[(0, 40, 0), (60, 100, 0)],
                   host=[("t2igan.a", 0, 50), ("t2igan.b", 50, 100)])
    assert spans.idle_us_by_span(t) == {"t2igan.a": 10.0, "t2igan.b": 10.0}


def test_idle_outside_every_span_is_nobodys():
    t = make_trace(kernels=[(10, 20, 10), (80, 90, 80)],
                   host=[("t2igan.a", 30, 40), ("bench.call", 0, 100)])
    idle = spans.idle_us_by_span(t)
    assert idle == {None: 70.0, "t2igan.a": 10.0}
    assert sum(idle.values()) == pytest.approx(1e6 * (t.window_s - t.busy_s))


def test_scaling_makes_the_parts_sum_to_the_untraced_idle():
    """Two traced calls of 100 us with 60 us busy each: 40 us of traced
    idle a call, shared 30 / 10; the untraced window, 5 calls in 400 us,
    leaves 20 us of idle a call, so the parts read 15 and 5 us."""
    t = make_trace(kernels=[(0, 60, 0), (130, 190, 100)], calls=2,
                   window=(0.0, 200.0),
                   host=[("t2igan.a", 0, 90), ("t2igan.b", 90, 100),
                         ("t2igan.a", 100, 180), ("t2igan.b", 180, 200)])
    r = reading(t, calls=5, seconds=400e-6)
    a, b = read("idle_ms.x.a", r), read("idle_ms.x.b", r)
    assert (a, b) == (pytest.approx(0.015), pytest.approx(0.005))
    untraced_idle_ms = 1e3 * (r.seconds / r.calls - t.busy_s / t.calls)
    assert a + b == pytest.approx(untraced_idle_ms)


def test_a_slower_untraced_window_never_reads_negative_idle():
    t = make_trace(kernels=[(0, 60, 0)], host=[("t2igan.a", 0, 100)])
    assert read("idle_ms.x.a", reading(t, seconds=50e-6)) == 0.0


def test_device_ms_counts_kernels_launched_inside_the_span():
    """A kernel runs after its span has closed and still counts; one
    launched before the span opened does not, wherever it runs."""
    t = make_trace(calls=2, host=[("t2igan.a", 10, 20), ("t2igan.a", 50, 60),
                                  ("t2igan.b", 0, 100)],
                   kernels=[(25, 40, 15), (30, 35, 5), (60, 64, 55),
                            (90, 99, 70)])
    assert read("device_ms.x.a", reading(t)) == pytest.approx(
        (15 + 4) / 1e3 / 2)
    # Nested spans included: the outer one holds every launch.
    assert read("device_ms.x.b", reading(t)) == pytest.approx(
        (15 + 5 + 4 + 9) / 1e3 / 2)


def test_host_us_is_per_occurrence_and_count_per_call():
    t = make_trace(calls=2, host=[("t2igan.a", 0, 10), ("t2igan.a", 20, 40),
                                  ("t2igan.a", 50, 80), ("t2igan.b", 0, 5)])
    assert read("host_us.x.a", reading(t)) == pytest.approx(20.0)
    assert read("count.x.a", reading(t)) == pytest.approx(1.5)
    assert read("count.x.c", reading(t)) == 0.0


@pytest.mark.parametrize("reader", spans.READERS)
def test_a_missing_span_reads_none(reader):
    """A trace of a program without spans: nothing to read, including
    the counts; a span missing beside others reads None except as a
    count."""
    bare = make_trace(kernels=[(0, 50, 0)], host=[("bench.call", 0, 100)])
    assert read(f"{reader}.x.a", reading(bare)) is None
    assert read(f"{reader}.x.a", harness.Reading(None, None, 1, 1.0,
                                                 None)) is None
    other = make_trace(kernels=[(0, 50, 0)], host=[("t2igan.b", 0, 100)])
    got = read(f"{reader}.x.a", reading(other))
    assert got == (0.0 if reader == "count" else None)


def test_span_of_drops_the_reader_and_the_entry():
    assert spans.span_of("idle_ms.train.gan.d_update") == \
        "t2igan.gan.d_update"
    assert spans.span_of("count.sample_f32.kernel.layout") == \
        "t2igan.kernel.layout"


def test_each_span_metric_reads_in_one_cell_that_reports_what_it_moves():
    e2e = {m["name"]: m.get("workloads") for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    found = [m for m in BENCH["per_layer"]
             if m["name"].split(".", 1)[0] in spans.READERS]
    assert len(found) == 23
    for m in found:
        assert spec.reader_path(ROOT, m["name"]).stem in spans.READERS
        (cell,) = m["workloads"]
        assert cell in cells and cell in e2e[m["moves"]]
        assert m["source"] == "device_trace" and m["better"] == "lower"
