"""Optimizers over the adapter tree."""
