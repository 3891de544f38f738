"""``idle_share.<entry>``: the share of an untraced call in which no
operation ran on the device, 1 - (device busy time a call: the union of
the device's operation intervals over the traced stretch, over its calls)
/ (the untraced window's time a call), in %.  The traced stretch's own
length is not the denominator: the profiler slows the host, so its idle
share reads high where the host sets the pace."""


def read(name, r):
    if r.trace is None or r.trace.calls <= 0 or r.calls <= 0 \
            or r.seconds <= 0:
        return None
    busy_per_call = r.trace.busy_s / r.trace.calls
    return 100.0 * (1.0 - busy_per_call / (r.seconds / r.calls))
