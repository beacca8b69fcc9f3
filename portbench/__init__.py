"""The port's benchmark: one run of one cell of ``BENCHMARK.json`` at a time
(``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``).  See ``portbench/README.md``."""
