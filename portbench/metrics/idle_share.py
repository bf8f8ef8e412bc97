"""% of the traced phase with no kernel on the device."""
from portbench.lib import readers


def read(run):
    return readers.idle_share(run)
