"""Synthetic federated data (numpy; a copy of the reference's)."""
