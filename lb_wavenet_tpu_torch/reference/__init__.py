"""Plain references of the architectures the port runs, written from their
papers in plain `torch`, importing nothing of the port."""
