"""The GATE port's benchmark: one cell of ``BENCHMARK.json`` run once.

``python gatebench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout; see ``README.md``.
"""
