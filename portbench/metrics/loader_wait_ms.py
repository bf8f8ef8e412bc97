"""Host ms per step waiting on the prefetch iterator's next(), over the
window."""
from portbench.lib import readers


def read(run):
    return readers.span_ms(run, "loader_wait")
