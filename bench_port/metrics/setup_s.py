"""setup_s: seconds from the process's start to the engine's first timed
work: imports, the kernels' build or load, the seeded weights, the
program's deploy, the engine's warm-up and graph capture (host clock)."""


def read(run):
    return run.setup_s
