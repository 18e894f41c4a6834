"""S1 (the port's Mamba2 SSD kernels, ``kernels/ssd.py``,
``csrc/ssd_chunked.cu``) against its roofline at the Zamba2 cell: the
least time the profiled sub-window's S1 calls could take, over the time the
kernels whose names start with ``ssd_`` took in the device trace, in %.

A forward call is counted by its one ``ssd_fwd`` kernel (the one that writes
y), a backward call by its one ``ssd_bwd`` kernel (the one that writes dx).
A call's least time is the larger of its operations at the bf16 peak
(``counts_zamba2.ssd_flops_per_token`` times batch times sequence, twice
that for a backward) and its bytes at the memory rate: a forward reads x,
dt, B, C and writes y and the final state, a backward reads x, dt, B, C, dy
and writes dx, ddt, dB, dC (x, y, B, C, dy, dx, dB, dC in bf16; dt, ddt and
the state in float32). Nothing where no ``ssd_`` kernel ran."""
from fpisa_bench import counts, counts_zamba2
from fpisa_bench.common import short_name

SOURCE = "device_trace"
MOVES = "train_tok_s"


def _named(prefix):
    return lambda name: short_name(name).startswith(prefix)


def call_bounds_s(cfg: dict, batch: int, seq: int) -> tuple[float, float]:
    """(forward, backward) least seconds of one S1 call on the whole batch."""
    di = cfg["mamba_expand"] * cfg["hidden_size"]
    p, g, n = cfg["mamba_headdim"], cfg["mamba_ngroups"], cfg["mamba_d_state"]
    h, tokens = di // p, batch * seq
    flops = counts_zamba2.ssd_flops_per_token(cfg) * tokens
    x, bc, dt = 2 * tokens * h * p, 2 * 2 * tokens * g * n, 4 * tokens * h
    fwd_bytes = x + dt + bc + x + 4 * batch * h * p * n
    bwd_bytes = x + dt + bc + x + x + dt + bc
    return (max(flops / counts.PEAK_FLOPS_BF16, fwd_bytes / counts.HBM_BYTES_PER_S),
            max(2 * flops / counts.PEAK_FLOPS_BF16, bwd_bytes / counts.HBM_BYTES_PER_S))


def read(r):
    p = r.profile
    if p is None:
        return None
    took = p.time_s(_named("ssd_"))
    fwd, bwd = p.count(_named("ssd_fwd")), p.count(_named("ssd_bwd"))
    if not took or not (fwd or bwd):
        return None
    f, b = call_bounds_s(r.cell.config, r.cell.traffic["batch"], r.cell.traffic["seq"])
    return 100 * (fwd * f + bwd * b) / took
