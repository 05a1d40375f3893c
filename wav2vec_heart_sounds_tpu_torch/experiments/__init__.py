"""Runners: the CinC scoring path."""
