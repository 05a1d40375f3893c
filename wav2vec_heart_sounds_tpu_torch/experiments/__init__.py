"""Runners: the CinC scoring path, and the loader helper of the training runners."""
