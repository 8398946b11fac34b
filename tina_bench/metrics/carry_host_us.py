"""carry_host_us (us): the mean host time of the program's
``stream.carry`` span (ChunkedRunner.push: the carry's ``torch.cat``
with the chunk, the window cut and the next carry sliced) over the
window's pushes (``TINA_TELEMETRY`` on in traced runs).  A program
without that span gives nothing to read."""


def read(w):
    durs = [e["dur"] for e in w.spans
            if e.get("name") == "stream.carry" and e.get("ph") == "X"]
    return sum(durs) / len(durs) if durs else None
