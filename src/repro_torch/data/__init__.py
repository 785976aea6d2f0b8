"""Synthetic fMoW data, partitioners and client batching (numpy copies of
the JAX package's data layer)."""
