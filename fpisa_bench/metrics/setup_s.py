"""Set-up time: process start to the first timed step (interpreter and
imports, the kernels' build or its cache check, the weights or inputs made
on the card from the seed, the warm-up and checked steps)."""
SOURCE = "host_clock"
MOVES = None


def read(r):
    return r.setup_s
