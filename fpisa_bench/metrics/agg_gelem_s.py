"""Aggregation goodput: gradient-tree elements aggregated per second over
the window (one tree's elements a call, not W x that), calls back to back,
the window closed by a synchronize."""
SOURCE = "host_clock"
MOVES = None


def read(r):
    return r.window.units / r.window.seconds / 1e9 if r.window.count else None
