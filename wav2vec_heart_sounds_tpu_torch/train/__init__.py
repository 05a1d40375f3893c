"""Training (losses, the float32-master optimizer, the supervised and generative trainers),
synthetic-dataset generation, evaluation and metrics."""
