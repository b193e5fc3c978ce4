"""The benchmark of ema_tpu_torch: one cell of BENCHMARK.json per run.

    python3 -m ema_bench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Everything that measures (the generator, the plain reference, the
reduction of traces and stage tables to metrics, the table of peaks)
lives in this package and imports nothing of ``ema_tpu``; the program
under test is ``ema_tpu_torch``.
"""
