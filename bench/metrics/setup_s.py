"""setup_s: process start to the first timed call (imports, kernel build
or load, instance generation, warm-up), on the host's clock."""


def read(run):
    return run.setup_s
