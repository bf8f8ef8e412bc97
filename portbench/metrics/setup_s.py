"""Seconds from the process's start to the start of the window: loading,
weights, corpus or payloads, the program's set-up and its warm-up."""


def read(run):
    return run.setup_s
