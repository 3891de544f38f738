"""``rank_ms.<entry>``: device ms a call of the kernels launched inside
the benchmark's ``bench.rank`` span, around the rank function."""


def read(name, r):
    if r.trace is None:
        return None
    kernels = r.trace.kernels_under("bench.rank")
    if not kernels:
        return None
    return sum(k["dur"] for k in kernels) / 1e3 / r.trace.calls
