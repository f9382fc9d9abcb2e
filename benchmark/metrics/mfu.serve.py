"""The model FLOPs of the traced units (``counts.py``) over the traced
window's wall time and the card's published bf16 peak (%)."""


def read(t):
    if t.kind != "serve" or t.window_s <= 0:
        return None
    return 100.0 * t.model_flops / t.window_s / t.peak_flops
