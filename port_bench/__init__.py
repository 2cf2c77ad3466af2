"""The benchmark of `path_tracer_tpu_torch` on one H100: `python -m
port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`.
See README.md."""
