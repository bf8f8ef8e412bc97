"""% of the bf16 peak: the window's steps times the operations of one step
(frontend, training stack and post-loss, forward and backward; the
upsampler's left out), over the window."""
from portbench.lib import costs


def read(run):
    if run.t0 is None or not run.steps:
        return None
    tr = run.train
    flops = costs.train_step_bound(run.arch, tr["batch_size"], tr["window_size"])["flops"]
    return 100.0 * run.steps * flops / run.window_s / costs.H100_BF16_FLOPS
