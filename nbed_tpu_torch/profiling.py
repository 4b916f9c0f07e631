"""Per-stage wall times of the embedding pipeline."""

import contextlib
import logging
import time

import torch

logger = logging.getLogger(__name__)

__all__ = ["StageTimer"]


class StageTimer:
    """Accumulates named stage wall times in ``timings`` (seconds).

    On a CUDA device each stage ends with ``torch.cuda.synchronize`` so the
    host clock covers the device work the stage queued, not its enqueue.
    """

    def __init__(self, device=None):
        self.timings: dict = {}
        self._sync = device is not None and torch.device(device).type == "cuda"

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.timings[name] = self.timings.get(name, 0.0) + dt
            logger.debug("stage %s: %.3f s", name, dt)
