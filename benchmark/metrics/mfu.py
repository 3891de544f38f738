"""``mfu.<entry>``: the whole call's model FLOPs (``benchmark.flops``,
from the configuration's shapes) over the untraced window's time, as a
share of the card's peak for the configuration's precision
(``benchmark.yardstick.MFU_PEAK``), in %."""

from benchmark.yardstick import MFU_PEAK


def read(name, r):
    if r.calls == 0 or r.seconds <= 0:
        return None
    rate = r.session.flops_per_call * r.calls / r.seconds
    return 100.0 * rate / MFU_PEAK[r.cell.dtype_name]
