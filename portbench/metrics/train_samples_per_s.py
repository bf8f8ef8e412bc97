"""Scored samples (batch x window) of the training steps run in the window,
over the window, which ends in a synchronise."""


def read(run):
    if run.t0 is None or not run.steps:
        return None
    return run.steps * run.train["batch_size"] * run.train["window_size"] / run.window_s
