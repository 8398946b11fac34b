"""throughput (Gsamples/s): every input sample whose outputs completed
in the window, over the window's seconds (the window ends with a
synchronize, so every call issued in it has completed)."""


def read(w):
    if not w.calls:
        return None
    return sum(c.samples for c in w.calls) / w.window_s / 1e9
