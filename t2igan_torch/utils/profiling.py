"""Named spans of the port in a ``torch.profiler`` trace.

``with span("t2igan.<layer>.<part>"):`` marks a region of the host's work
as a ``user_annotation`` event of the trace, on the clock of the CUDA
kernels and runtime calls beside it, so a device gap or a kernel can be put
down to the program phase the host was in (open the trace in Perfetto or
``chrome://tracing``; ``PERF.md`` lists every span).  Counterpart of
``t2igan.utils.profiling.annotate``.

A span is recorded only while a profiler records.  Otherwise ``span``
returns one shared no-op context: with no profiler on, entering and
leaving a ``record_function`` takes ~13 us on a CPU core (torch 2.13),
the profiler's enabled flag a fraction of a microsecond to read.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function(name)`` while a profiler
    records, else a shared no-op context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
