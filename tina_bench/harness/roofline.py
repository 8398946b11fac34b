"""The ``*_roofline`` readers' arithmetic: a node's counted bound over the
device time of the kernels whose names match its patterns."""
import re
import sys


def share(w, node: str, patterns: list[str], metric: str):
    """100 * sum of the calls' ``node`` bounds / the matched kernels'
    device seconds in the traced window; None (and a loud line) when no
    kernel matched."""
    if w.trace is None or not w.calls:
        return None
    rx = re.compile("|".join(patterns))
    t = sum(b - a for name, a, b in w.trace["kernels"] if rx.search(name))
    if t <= 0:
        print(f"{metric}: no device interval matched {patterns}; the "
              "kernels were renamed or left the path", file=sys.stderr)
        return None
    bound = sum(w.counts(c)[node].seconds() for c in w.calls)
    return 100.0 * bound / t
