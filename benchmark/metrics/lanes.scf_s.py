"""lanes.scf_s: per batch of the traced stretch, the host seconds of the
lane program's "embed.global_ks" and "embed.embedded_hf" ranges."""


def read(run):
    t = run.trace
    if t is None or not t.requests:
        return None
    spans = [t.ranges.get(name) for name in ("embed.global_ks", "embed.embedded_hf")]
    if None in spans:
        return None
    return sum(spans) / t.requests
