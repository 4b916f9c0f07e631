"""setup_s: seconds from process start to the first timed request
(imports, the kernel libraries, the entry's set-up, the warm-up requests)."""


def read(run):
    return run.setup_s
