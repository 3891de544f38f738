"""``count.<entry>.<span>``: occurrences a call of the program's span
``t2igan.<span>`` over the traced stretch; 0 where the program records
spans but never entered this one.  Nothing to read where the trace holds
no program span at all."""

from benchmark import spans


def read(name, r):
    if r.trace is None or not spans.program_spans(r.trace):
        return None
    return len(r.trace.spans(spans.span_of(name))) / r.trace.calls
