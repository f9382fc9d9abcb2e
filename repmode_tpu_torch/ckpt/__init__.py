"""Checkpoints in the reference .p layout and the checkpoint policy."""
