"""The control of `correct`: the numbers a cell's check reads when the
plain reference, computed in bfloat16 (the precision below the float32
the configurations state), stands in the program's place.  The
benchmark's own runs do not run it.

    python -m port_bench.control --workload <cell> --units <n> \
        --seeds <s> [<s> ...] [--device cuda]

`--units` is the number of frames (or passes) a run of the cell checks.
One JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from port_bench import harness


def readings(name: str, seed: int, units: int, device, overrides=None,
             bench_path=harness.BENCHMARK, root=harness.ROOT) -> dict:
    b = harness.bench(bench_path)
    ctx = harness.context(b, name, seed, device, overrides, root,
                          harness.Path(bench_path).parent)
    return ctx.kind.control(ctx, units)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--units", type=int, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("port_bench.control: no CUDA device", file=sys.stderr)
        return 3
    for s in a.seeds:
        r = readings(a.workload, s, a.units, a.device)
        print(json.dumps(dict(workload=a.workload, seed=s, units=a.units,
                              readings=r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
