"""Thread-seconds of the cloud EM on the main thread (``em[device]`` of
the port's Metrics: dispatch and wait) per 1,000 pairs."""


def read(run):
    st = run.stages
    if "em[device]" not in st or not run.pairs:
        return None
    return st["em[device]"] / (run.pairs / 1000.0)
