"""Serving: paged decode step and the jit-resident engine."""
