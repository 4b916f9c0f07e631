"""stage.scf_s: per request, the driver's SCF stages (NbedDriver.timings:
global_ks, subsystem_dft and the embedded SCFs), host clock synchronised
at each stage's end."""

STAGES = ("global_ks", "subsystem_dft", "mu_embed", "huzinaga_embed")


def read(run):
    done = [r for r in run.completed if r["timings"]]
    if not done:
        return None
    return sum(sum(r["timings"].get(s, 0.0) for s in STAGES) for r in done) / len(done)
