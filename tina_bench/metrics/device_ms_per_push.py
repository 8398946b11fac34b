"""device_ms_per_push (ms): the union of the device's busy intervals in
the traced window, per call."""


def read(w):
    if w.trace is None or w.trace["busy_s"] <= 0 or not w.calls:
        return None
    return w.trace["busy_s"] * 1e3 / len(w.calls)
