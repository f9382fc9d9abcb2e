"""Experiment loop of the port (eval pass only so far)."""
