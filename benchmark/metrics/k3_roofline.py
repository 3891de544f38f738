"""``k3_roofline.<entry>``: the fused stage tail's least time for a call
(``benchmark.yardstick.k3_bound_ms``: the larger of its bytes at the
memory rate and its work at bf16's rate, or as 3xTF32 in f32) over the
device time of its kernels in the trace (the ``K3`` families), in %.
Nothing to read where no K3 kernel ran."""


def read(name, r):
    if r.trace is None or r.session.k3_bound_ms is None:
        return None
    ms = sum(v for k, v in r.trace.ms_by_family().items()
             if k.startswith("K3"))
    if ms <= 0:
        return None
    return 100.0 * r.session.k3_bound_ms / ms
