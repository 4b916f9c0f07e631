"""post.dft_in_dft_s: per completed request, the host seconds of the DFT-
in-DFT check: every "post.dft_in_dft" span (one more embedded KS SCF,
the deletion and one get_veff), summed from the request's span table
(NbedDriver.timings). None where no request has such a span, as in a
program without spans."""

SPAN = "post.dft_in_dft"


def read(run):
    done = [r["timings"] for r in run.completed]
    if not any(SPAN in t for t in done):
        return None
    return sum(t.get(SPAN, 0.0) for t in done) / len(done)
