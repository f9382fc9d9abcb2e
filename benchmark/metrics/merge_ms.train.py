"""Device ms a train step in the merge bucket: the MoDE gate-merge einsums
(with the k2s2 resample matmuls, which share cuBLAS's kernels)."""


def read(t):
    if t.kind != "train" or t.units <= 0:
        return None
    return 1e3 * t.merge_s() / t.units
