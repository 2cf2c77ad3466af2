"""python -m port_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>: one run of one cell of BENCHMARK.json on this machine's
CUDA devices; the last line of standard output is the result."""
import os
import sys
from pathlib import Path

# caches at fixed paths inside the checkout (the port builds K1 with nvcc
# into path_tracer_tpu_torch/ops/_build/, which is inside it too)
os.environ["TRITON_CACHE_DIR"] = str(Path(__file__).resolve().parent
                                     / ".cache" / "triton")

if __name__ == "__main__":
    import torch
    torch.set_num_threads(4)
    from port_bench.harness import main
    sys.exit(main())
