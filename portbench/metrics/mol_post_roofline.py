"""% of the MoL head pair's roofline a training step: its bound for one
forward and one backward call (`lib/mol_costs.py` at the recipe's B and W)
over the device time a step of its `__global__` launches (csrc/post_mol.cu)
in the traced phase."""
from portbench.lib import mol_costs, mol_readers


def read(run):
    us = mol_readers.head_us_per_step(run)
    if us is None:
        return None
    tr = run.train
    return 100.0 * mol_costs.mol_post_bound_ms(run.arch, tr["batch_size"], tr["window_size"]) / (
        1e-3 * us)
