"""embed_p90_s: the 90th percentile (linear interpolation) of the wall
times of all requests of the window, failed ones at infinity."""

import numpy as np


def read(run):
    walls = [r["wall_s"] if r["ok"] else np.inf for r in run.requests]
    return float(np.percentile(walls, 90)) if len(walls) >= 10 else None
