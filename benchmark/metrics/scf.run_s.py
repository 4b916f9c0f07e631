"""scf.run_s: per completed request, the host seconds of the SCF cycles:
every "scf.run" span of the request (a graphed SCF's replays with one
host read each, its polish and final build; the eager loop off the
graphs), summed from the request's span table (NbedDriver.timings). None
where no request has such a span, as in a program without spans."""

SPAN = "scf.run"


def read(run):
    done = [r["timings"] for r in run.completed]
    if not any(SPAN in t for t in done):
        return None
    return sum(t.get(SPAN, 0.0) for t in done) / len(done)
