"""% of the training stack backward's roofline per call (device trace)."""
from portbench.lib import readers


def read(run):
    return readers.stack_roofline(run, backward=True)
