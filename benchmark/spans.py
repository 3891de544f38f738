"""The program's own spans in a trace: the ``t2igan.*`` regions that
``t2igan_torch.utils.profiling.span`` records on the host while a profiler
runs, on the clock of the device's kernels.  Read per layer by
``metrics/device_ms.py``, ``idle_ms.py``, ``host_us.py`` and ``count.py``.

A metric ``<reader>.<entry>.<span>`` reads the span ``t2igan.<span>``:
``idle_ms.train.gan.d_update`` reads ``t2igan.gan.d_update``; the entry
part ties each name to one cell's end-to-end metric.  A program without
the span leaves the metric unread (None).
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

PREFIX = "t2igan."
READERS = ("device_ms", "idle_ms", "host_us", "count")


def span_of(metric: str) -> str:
    """The span a metric ``<reader>.<entry>.<span>`` reads."""
    return PREFIX + metric.split(".", 2)[2]


def program_spans(trace) -> List[dict]:
    """The trace's host events that are the program's spans."""
    return [e for e in trace.host_ops if e["name"].startswith(PREFIX)]


def idle_gaps(trace) -> List[Tuple[float, float]]:
    """(start, end) of each stretch of the traced window in which no
    operation ran on the device, in time order."""
    lo, hi = trace.window
    gaps, at = [], lo
    for s, e in trace.busy_intervals():
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def timeline(spans: List[dict]) -> List[Tuple[float, float, Optional[str]]]:
    """(start, end, name) pieces between consecutive span boundaries, each
    named after the innermost span open over it: the latest-started one
    on any thread, the shorter of two that start together; None where no
    span is open."""
    points = sorted({e["ts"] for e in spans}
                    | {e["ts"] + e["dur"] for e in spans})
    by_start = sorted(spans, key=lambda e: e["ts"])
    out, active, k = [], [], 0
    for a, b in zip(points, points[1:]):
        while k < len(by_start) and by_start[k]["ts"] <= a:
            active.append(by_start[k])
            k += 1
        active = [e for e in active if e["ts"] + e["dur"] > a]
        inner = max(active, key=lambda e: (e["ts"], -e["dur"]),
                    default=None)
        out.append((a, b, None if inner is None else inner["name"]))
    return out


def idle_us_by_span(trace) -> Dict[Optional[str], float]:
    """Device-idle microseconds over the traced window by the innermost
    program span open on the host (:func:`timeline`); a gap that crosses a
    span boundary is split there.  Idle while no program span is open is
    under None.  The values sum to the window's idle time."""
    pieces = timeline(program_spans(trace))
    out: Dict[Optional[str], float] = collections.defaultdict(float)
    j = 0
    for gs, ge in idle_gaps(trace):
        while j < len(pieces) and pieces[j][1] <= gs:
            j += 1
        t, k = gs, j
        while t < ge:
            if k == len(pieces) or pieces[k][0] >= ge:
                out[None] += ge - t
                break
            a, b, name = pieces[k]
            if a > t:
                out[None] += a - t
                t = a
            end = min(b, ge)
            out[name] += end - t
            t = end
            k += 1
    return dict(out)
