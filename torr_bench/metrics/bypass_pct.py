"""Valid proposals of the windows delivered in the window whose path was
bypass, over all their valid proposals (the query cache's hit share)."""
import numpy as np

from tbench import readings as rd


def read(ctx):
    n = hit = 0
    for w in rd.resolved_in_window(ctx):
        p = w.path[:w.n_valid]
        n += p.size
        hit += int(np.count_nonzero(p == 0))
    return 100.0 * hit / n if n else None
