"""device_idle_share (%): 1 - (union of the device's kernel, copy and
set intervals) / the traced window, from torch.profiler."""


def read(w):
    if w.trace is None or w.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - w.trace["busy_s"] / w.trace["window_s"])
