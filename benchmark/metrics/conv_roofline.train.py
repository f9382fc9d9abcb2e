"""The least time of the 'same' convs the traced units need (``counts.py``:
per conv the larger of FLOPs over the peak and bytes over the bandwidth)
over the device time of the buckets that do conv work (%)."""


def read(t):
    if t.kind != "train" or t.conv_s() <= 0:
        return None
    return 100.0 * t.conv_bound_s / t.conv_s()
