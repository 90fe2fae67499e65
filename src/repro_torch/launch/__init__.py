"""Runnable entry points."""
