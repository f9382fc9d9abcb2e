"""Share of the traced window in which no operation ran on the device (%)."""


def read(t):
    if t.kind != "serve" or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
