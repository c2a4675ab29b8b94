"""Procedural system builders (the input-deck layer)."""
