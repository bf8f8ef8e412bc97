"""Device ms a training step of the MoL head pair's launches (csrc/post_mol.cu,
by their `__global__` names in the trace), over the traced phase."""
from portbench.lib import mol_readers


def read(run):
    us = mol_readers.head_us_per_step(run)
    return None if us is None else 1e-3 * us
