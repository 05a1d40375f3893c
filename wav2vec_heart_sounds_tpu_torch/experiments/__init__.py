"""Runners: CinC (scoring and training), the vest, the synthetic schedule, and the loader
helper of the training runners."""
