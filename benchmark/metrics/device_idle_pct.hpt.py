"""Share of the traced stretch of the window in which no kernel, copy or
fill ran on the card: 1 − (union of the device intervals) ÷ (the
stretch's length on the host's clock), in percent."""


def read(run):
    p = run.profile
    if p is None or p.window_s <= 0 or not p.device:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
