"""% of the bf16 peak: the window's steps times the operations of one mol
training step (the scalar frontend, the training stack and the MoL head,
forward and backward; the upsampler's left out), over the window."""
from portbench.lib import costs, mol_costs


def read(run):
    if run.t0 is None or not run.steps:
        return None
    tr = run.train
    flops = mol_costs.mol_step_flops(run.arch, tr["batch_size"], tr["window_size"])
    return 100.0 * run.steps * flops / run.window_s / costs.H100_BF16_FLOPS
