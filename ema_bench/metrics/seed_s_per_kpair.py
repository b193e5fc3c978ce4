"""Thread-seconds of seeding and locate on the chunk workers
(``seed[smem,host]`` + ``locate[native,host]`` of the port's Metrics)
per 1,000 pairs."""


def read(run):
    st = run.stages
    keys = ("seed[smem,host]", "locate[native,host]")
    if not any(k in st for k in keys) or not run.pairs:
        return None
    return sum(st.get(k, 0.0) for k in keys) / (run.pairs / 1000.0)
