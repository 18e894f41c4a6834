"""Training throughput: the tokens of every step issued in the window over
the window's seconds (host clock, from a synchronize to the synchronize
after the last step)."""
SOURCE = "host_clock"
MOVES = None


def read(r):
    return r.window.units / r.window.seconds if r.window.count else None
