"""kernels_host_us (us): the host time of the program's ``node.<op>``
spans (``plan._execute``: each node's OpDef impl and kernel wrapper, its
checks, allocations, copies and launches) per push: summed over the
window's nodes, over the ``stream.push`` spans.  A program without those
spans gives nothing to read."""


def read(w):
    pushes = sum(1 for e in w.spans
                 if e.get("name") == "stream.push" and e.get("ph") == "X")
    durs = [e["dur"] for e in w.spans
            if e.get("name", "").startswith("node.") and e.get("ph") == "X"]
    return sum(durs) / pushes if pushes and durs else None
