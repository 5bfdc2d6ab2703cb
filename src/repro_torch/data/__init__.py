"""Synthetic training data (numpy, the same batches as the JAX package's)."""
