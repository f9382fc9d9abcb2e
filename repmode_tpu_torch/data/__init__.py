"""Volume store and synthetic data of the port."""
