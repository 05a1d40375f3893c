"""Evaluation and metrics."""
