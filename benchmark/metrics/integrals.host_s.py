"""integrals.host_s: per completed request, the host seconds of the host
C++ integrals at the request's geometry: every "integrals.native" span
(each engine's one-electron integrals and ERIs), summed from the
request's span table (NbedDriver.timings). None where no request has
such a span, as in a program without spans."""

SPAN = "integrals.native"


def read(run):
    done = [r["timings"] for r in run.completed]
    if not any(SPAN in t for t in done):
        return None
    return sum(t.get(SPAN, 0.0) for t in done) / len(done)
