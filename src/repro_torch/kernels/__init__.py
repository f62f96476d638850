"""The port's hand-written Hopper kernels and their plain versions."""
