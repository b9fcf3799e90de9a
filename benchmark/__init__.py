"""The port's benchmark: ``python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
