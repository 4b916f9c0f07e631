"""device.idle.<cells>: 1 - (self device time of kernels and copies, ranges left
out) / wall, over the traced stretch, in percent."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
