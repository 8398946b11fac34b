"""push_host_us (us): the mean host time of the program's
``stream.push`` span (ChunkedRunner.push: the plan lookup and the run's
dispatch) over the window's pushes (``TINA_TELEMETRY`` on in traced
runs)."""


def read(w):
    durs = [e["dur"] for e in w.spans
            if e.get("name") == "stream.push" and e.get("ph") == "X"]
    return sum(durs) / len(durs) if durs else None
