"""The whole aggregation call's share of the card's peak: the bytes its
kernels must move (``counts.fpisa_bytes_per_elem``; the call is bound by
memory, so the peak is the memory rate) for every call of the traced run's
window, over that window's seconds, in %. It bounds what any one kernel's
share can give end to end."""
from fpisa_bench import counts

SOURCE = "host_clock"
MOVES = "agg_gelem_s"


def read(r):
    if not r.window.count:
        return None
    t = r.cell.traffic
    per_elem = counts.fpisa_bytes_per_elem(t["workers"], counts.DTYPE_BYTES[t["dtype"]])
    return 100 * r.window.units * per_elem / r.window.seconds / counts.HBM_BYTES_PER_S
