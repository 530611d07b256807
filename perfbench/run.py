"""Run one cell of the benchmark once and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``compared``: each number the
correctness check compared, beside its limit); the compared numbers are
also the last lines of standard error. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics. No result is
printed, and the exit code is not 0, without as many CUDA devices as the
cell asks for, or when the JAX package or JAX was loaded.

Build outputs and kernel caches stay in ``build/`` inside the checkout.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "cuda_cache"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    from perfbench import harness

    cell = harness.cell_of(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              "available", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = harness.run_cell(bench, args.workload, seed=args.seed,
                              seconds=args.seconds, traced=bool(args.trace),
                              device="cuda", t0=STARTED)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"the benchmark's process loaded {loaded}", file=sys.stderr)
        return 3
    emit(result)
    return 0


def emit(result) -> None:
    """The run's phases and compared numbers on standard error, the compared
    numbers last; the result as the last line of standard output."""
    print(f"phases {json.dumps(result.get('phases'))}", file=sys.stderr)
    for name, pair in result["compared"].items():
        print(f"compared {name} {pair['value']!r} limit {pair['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
