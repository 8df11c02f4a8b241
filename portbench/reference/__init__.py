"""Plain float32 references, one file per family, in PyTorch operations
alone: they import neither the port nor JAX, and take from the
benchmark only the weights it drew and the inputs and served tokens to
judge."""
