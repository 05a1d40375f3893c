"""Fragments, host batching, the dataset builders and the generator datasets (numpy copies
and ports of the JAX package's data layer)."""
