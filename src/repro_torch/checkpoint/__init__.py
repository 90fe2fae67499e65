"""Checkpointing (port of ``repro.checkpoint``): adapter/param trees to npz
with the reference's key strings, and atomic pickled round-state blobs."""
