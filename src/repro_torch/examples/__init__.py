"""Counterparts of the reference's ``examples/`` (quickstart, threshold
sweep, the federated round → deploy loop), run as ``python -m
repro_torch.examples.<name> [--device cpu]``."""
