"""conformers_per_s: conformers of the completed requests over the
window's seconds."""


def read(run):
    units = sum(r["units"] for r in run.completed)
    return units / run.window_s if units else None
