"""Sliding-window tiled inference of the port."""
