"""launches_per_push (launches): the port's kernel wrappers' ``*LAUNCHES``
counters (one a C entry call) added over the window, per call."""


def read(w):
    if not w.calls:
        return None
    return sum(w.launches.values()) / len(w.calls)
