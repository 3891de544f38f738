"""``device_ms.<entry>.<span>``: device ms a call of the kernels whose
launch lies inside the program's span ``t2igan.<span>``
(``Trace.kernels_under``: any thread's launch, nested spans included).
Nothing to read where the trace holds no such span."""

from benchmark import spans


def read(name, r):
    if r.trace is None:
        return None
    span = spans.span_of(name)
    if not r.trace.spans(span):
        return None
    kernels = r.trace.kernels_under(span)
    return sum(k["dur"] for k in kernels) / 1e3 / r.trace.calls
