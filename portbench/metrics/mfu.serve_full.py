"""% of the bf16 peak in model operations of the samples delivered in the
window."""
from portbench.lib import readers


def read(run):
    return readers.serve_mfu(run)
