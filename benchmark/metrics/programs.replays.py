"""programs.replays: CUDA-graph replays per request over the window
(nbed_tpu_torch.ops.programs.RUNS["replays"])."""

COUNTERS = ["nbed_tpu_torch.ops.programs:RUNS"]


def read(run):
    done = run.completed
    if not done:
        return None
    return run.counter(COUNTERS[0])["replays"] / len(done)
