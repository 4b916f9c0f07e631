"""post.ham_s: per completed request, the host seconds of the
second-quantised Hamiltonian: every "ham.build" span (each
HamiltonianBuilder.build(), those inside CCSD and FCI included), summed
from the request's span table (NbedDriver.timings). None where no
request has such a span, as in a program without spans."""

SPAN = "ham.build"


def read(run):
    done = [r["timings"] for r in run.completed]
    if not any(SPAN in t for t in done):
        return None
    return sum(t.get(SPAN, 0.0) for t in done) / len(done)
