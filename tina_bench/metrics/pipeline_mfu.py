"""pipeline_mfu (%): the window's counted least time over its seconds:
every call's whole-pipeline bound (``counts``: its input read once, its
output written once, every node's operations at their pipes' peaks)
summed, over the traced window.  The whole step's share of the card's
peak: fusing or removing a kernel cannot lift it past 100."""


def read(w):
    if w.trace is None or not w.calls:
        return None
    least = sum(w.counts(c)["pipeline"].seconds() for c in w.calls)
    return 100.0 * least / w.trace["window_s"]
