"""Seconds from the process's start to the first timed unit: imports,
kernels and the native library loaded or built, the index loaded, the
inputs made and one warm-up unit."""


def read(run):
    return run.setup_s
