"""post.ccsd_s: per completed request, the host seconds of the embedded
CCSD: every "post.ccsd" span (its Hamiltonian build, set-up and sweep),
summed from the request's span table (NbedDriver.timings). None where no
request has such a span, as in a program without spans."""

SPAN = "post.ccsd"


def read(run):
    done = [r["timings"] for r in run.completed]
    if not any(SPAN in t for t in done):
        return None
    return sum(t.get(SPAN, 0.0) for t in done) / len(done)
