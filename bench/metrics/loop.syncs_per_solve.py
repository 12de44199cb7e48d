"""loop.syncs_per_solve: synchronising CUDA calls in one solve of its own,
counted by torch's sync debug mode before the traced window."""


def read(run):
    return run.syncs_per_solve
