"""plan_lookup_us (us): the host time of the program's ``plan.lookup``
span (``compile``: the options and shapes made into the plan cache's
key, the graph's signature among them, and the cache's answer) per
push: summed over the window, over the ``stream.push`` spans.  A
program without that span gives nothing to read."""


def read(w):
    pushes = sum(1 for e in w.spans
                 if e.get("name") == "stream.push" and e.get("ph") == "X")
    durs = [e["dur"] for e in w.spans
            if e.get("name") == "plan.lookup" and e.get("ph") == "X"]
    return sum(durs) / pushes if pushes and durs else None
