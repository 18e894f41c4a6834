"""Host issue of one aggregation call: the host clock around each
``allreduce_tree`` call of the window, without a synchronize (the call
returns once its work is queued, or once the queue lets it); the median
over the window's calls, in ms."""
import statistics

SOURCE = "host_clock"
MOVES = "agg_gelem_s"


def read(r):
    return 1e3 * statistics.median(r.issue_s) if r.issue_s else None
