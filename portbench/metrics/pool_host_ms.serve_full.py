"""Host ms per pool step in the pool's own phases (reset, cond, dispatch,
slice, submit; the device wait, fetch, left out), from SessionPool.stats
over the window."""
from portbench.lib import readers


def read(run):
    return readers.pool_ms(run, ("reset_s", "cond_s", "dispatch_s", "slice_s", "submit_s"))
