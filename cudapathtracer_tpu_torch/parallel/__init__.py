"""Rendering over several ranks (parallel/sharding.py)."""
