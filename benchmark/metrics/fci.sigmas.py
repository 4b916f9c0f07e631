"""fci.sigmas.<cells>: matrix-free FCI products sigma = H c per completed
request over the window (nbed_tpu_torch.solvers.fci.SIGMAS["sigma"]): the
Davidson iterations of the embedded FCI."""

COUNTERS = ["nbed_tpu_torch.solvers.fci:SIGMAS"]


def read(run):
    done = run.completed
    if not done:
        return None
    return run.counter(COUNTERS[0])["sigma"] / len(done)
