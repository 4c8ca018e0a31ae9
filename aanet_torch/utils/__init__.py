"""Checkpoint I/O of the port (``checkpoint``: reading the JAX package's flax files)."""
