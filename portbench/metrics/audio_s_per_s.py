"""Seconds of audio delivered to requests per second of the window: every
sample a pool step handed back inside the window counts, those of
requests still in flight at its end included."""
from portbench.lib import readers


def read(run):
    if run.t0 is None or not run.requests:
        return None
    return readers.delivered(run) / run.arch["sample_rate"] / run.window_s
