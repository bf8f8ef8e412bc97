"""Device-idle ms a training step while the host is inside the program's
span train.backward, over the traced phase (lib/program_spans.py)."""
from portbench.lib import program_spans


def read(run):
    return program_spans.idle_ms(run, "backward")
