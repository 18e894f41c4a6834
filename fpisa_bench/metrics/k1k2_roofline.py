"""K1 (exponent and wire modes) and K2 (``kernels/fpisa_fused.py``,
``csrc/fpisa_fused.cu``) against their roofline: the bytes the profiled
calls' kernels must move (``counts.fpisa_bytes_per_elem`` of each tree
element at the cell's workers and dtype) at the memory rate, over the time
those kernels took in the device trace, in %."""
from fpisa_bench import counts

SOURCE = "device_trace"
MOVES = "agg_gelem_s"
KERNELS = ("block_max_kernel", "encode_wire_kernel", "decode_kernel")


def _k1k2(name):
    return any(k + "<" in name for k in KERNELS)


def read(r):
    p = r.profile
    if p is None:
        return None
    took = p.time_s(_k1k2)
    if not took or not r.window.count:
        return None
    t = r.cell.traffic
    elements = r.window.units / r.window.count  # one tree's, a call
    per_elem = counts.fpisa_bytes_per_elem(t["workers"], counts.DTYPE_BYTES[t["dtype"]])
    return 100 * p.units * elements * per_elem / counts.HBM_BYTES_PER_S / took
