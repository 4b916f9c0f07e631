"""stage.post_s: per request, localization and the post-embedding stages
(NbedDriver.timings: localize, mu_post_embed, huzinaga_post_embed: deletion,
concentric virtuals, CCSD, FCI, DFT-in-DFT, the Hamiltonian)."""

STAGES = ("localize", "mu_post_embed", "huzinaga_post_embed")


def read(run):
    done = [r for r in run.completed if r["timings"]]
    if not done:
        return None
    return sum(sum(r["timings"].get(s, 0.0) for s in STAGES) for r in done) / len(done)
