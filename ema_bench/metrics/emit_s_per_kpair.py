"""Thread-seconds of selection and SAM text on the main thread
(``select+emit[host]`` of the port's Metrics) per 1,000 pairs."""


def read(run):
    st = run.stages
    if "select+emit[host]" not in st or not run.pairs:
        return None
    return st["select+emit[host]"] / (run.pairs / 1000.0)
