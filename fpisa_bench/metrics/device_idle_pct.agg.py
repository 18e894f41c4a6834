"""The card's idle share in aggregation: the share of the profiled
sub-window (torch.profiler, the calls after the window) in which no device
operation ran, in %."""
SOURCE = "device_trace"
MOVES = "agg_gelem_s"


def read(r):
    p = r.profile
    return 100 * (1 - p.busy_s / p.window_s) if p is not None and p.window_s else None
