"""plan_run_self_us (us): the self time of the program's ``plan.run``
span (``Plan.__call__``: the consts' readiness, the input checks, the
outputs made the caller's own) per push: each span's duration less the
part its child spans cover (the ``node.*`` spans; a sharded plan's
per-shard ``plan.run``), summed over the window, over the
``stream.push`` spans.  A program without those spans gives nothing to
read."""


def _children_us(spans) -> dict:
    """id(span) -> the microseconds its direct children cover, spans
    nesting within each thread's track."""
    tracks: dict = {}
    for e in spans:
        if e.get("ph") == "X":
            tracks.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    covered: dict = {}
    for track in tracks.values():
        # a parent opens before (or with) its children
        track.sort(key=lambda e: (e["ts"], -e["dur"]))
        open_: list = []
        for e in track:
            while open_ and e["ts"] >= open_[-1]["ts"] + open_[-1]["dur"]:
                open_.pop()
            if open_:
                parent = id(open_[-1])
                covered[parent] = covered.get(parent, 0.0) + e["dur"]
            open_.append(e)
    return covered


def read(w):
    pushes = sum(1 for e in w.spans
                 if e.get("name") == "stream.push" and e.get("ph") == "X")
    runs = [e for e in w.spans
            if e.get("name") == "plan.run" and e.get("ph") == "X"]
    if not pushes or not runs:
        return None
    covered = _children_us(w.spans)
    return sum(e["dur"] - covered.get(id(e), 0.0) for e in runs) / pushes
