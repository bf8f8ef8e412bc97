"""The benchmark of the PyTorch/CUDA port (lb_wavenet_tpu_torch): its
harness, traffic, configurations, metric readers and plain reference.
`python3 -m portbench.run --help`."""
