"""Shared configuration (copies of the reference's jax-free config)."""
