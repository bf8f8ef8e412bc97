"""% of mega_generate's roofline in the full pool (device trace)."""
from portbench.lib import readers


def read(run):
    return readers.mega_roofline(run)
