"""Device ms a train step in kernels outside the conv and merge buckets:
copies, casts, BN, elementwise, Adam."""


def read(t):
    if t.kind != "train" or t.units <= 0:
        return None
    return 1e3 * (t.kernel_s() - t.conv_s() - t.merge_s()) / t.units
