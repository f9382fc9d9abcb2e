"""Volume store, synthetic data and the patch sampler of the port."""
