"""``idle_ms.<entry>.<span>``: device-idle ms a call while the program's
span ``t2igan.<span>`` is the innermost program span open on the host
(``benchmark.spans.idle_us_by_span``: each idle gap of the traced window
split at the spans' boundaries), scaled by the untraced call's idle over
the traced call's, as ``idle_share`` corrects for the profiler's slowdown
of the host: the parts of a call sum to at most its untraced idle.
Nothing to read where the trace holds no such span."""

from benchmark import spans


def read(name, r):
    t = r.trace
    if t is None or t.calls <= 0 or r.calls <= 0 or r.seconds <= 0:
        return None
    span = spans.span_of(name)
    if not t.spans(span):
        return None
    busy = t.busy_s / t.calls
    traced = t.window_s / t.calls - busy
    untraced = r.seconds / r.calls - busy
    scale = max(0.0, untraced) / traced if traced > 0 else 0.0
    idle_us = spans.idle_us_by_span(t).get(span, 0.0)
    return idle_us / 1e3 / t.calls * scale
