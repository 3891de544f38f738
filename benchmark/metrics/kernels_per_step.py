"""``kernels_per_step.<entry>``: kernels launched on the device a call
(a step), counted in the trace."""


def read(name, r):
    if r.trace is None:
        return None
    return len(r.trace.kernels) / r.trace.calls
