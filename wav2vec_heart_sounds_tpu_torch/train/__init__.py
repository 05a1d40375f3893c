"""Training (losses, the float32-master optimizer, the supervised trainer), evaluation and metrics."""
