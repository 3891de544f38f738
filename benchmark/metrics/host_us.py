"""``host_us.<entry>.<span>``: host microseconds of one occurrence of the
program's span ``t2igan.<span>``, the mean over the traced stretch.
Nothing to read where the trace holds no such span."""

from benchmark import spans


def read(name, r):
    if r.trace is None:
        return None
    found = r.trace.spans(spans.span_of(name))
    if not found:
        return None
    return sum(e - s for s, e in found) / len(found)
