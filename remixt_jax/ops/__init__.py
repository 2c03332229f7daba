"""JAX/XLA numerical kernels for the inference engine."""
