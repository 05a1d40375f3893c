"""Fragments and host batching (numpy copies of the JAX package's data layer)."""
