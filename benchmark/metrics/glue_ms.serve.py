"""Device ms a served volume in kernels outside the conv buckets: copies,
casts, resample GEMMs, elementwise, the stitch."""


def read(t):
    if t.kind != "serve" or t.units <= 0:
        return None
    return 1e3 * (t.kernel_s() - t.conv_s()) / t.units
