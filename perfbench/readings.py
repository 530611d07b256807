"""The readings that a cell's correctness limits are set from, on the chip
at the cell's own size (not part of the benchmark's runs).

    python3 perfbench/readings.py --workload <cell> --seeds 12 --faults 3 \
        --first-seed <n> [--out FILE]

For each of ``--seeds`` seeds from ``--first-seed`` on: the program's
first steps (the cell's set-up, no window) against the plain reference,
the three compared numbers (the lower readings). For the first
``--faults`` of them, the reference put in the program's place, computed
in TF32 (the control) and with each fault of
:data:`perfbench.reference.train.FAULTS`, against the same f32 reference
(the upper readings). Prints one JSON line per reading and, last, the
largest sound reading and the smallest control and fault readings of each
number.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--faults", type=int, default=3)
    parser.add_argument("--first-seed", type=int, required=True)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from perfbench import harness, traffic
    from perfbench.kinds import train
    from perfbench.reference.train import FAULTS, follow

    if not torch.cuda.is_available():
        print("readings need a CUDA device", file=sys.stderr)
        return 2
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.cell_of(bench, args.workload)
    conf, mix = harness.load_config(cell["config"]), traffic.load(cell["traffic"])
    lines = []

    def emit(**row):
        row["at_s"] = time.perf_counter() - STARTED
        lines.append(row)
        print(json.dumps(row), flush=True)

    for i in range(args.seeds):
        seed = args.first_seed + i
        trainer, program, _ = train.start(conf, mix, seed, "cuda")
        del trainer
        train.free("cuda")
        reference = follow(conf, mix, seed, "cuda")
        emit(seed=seed, side="program", **train.gaps(program, reference),
             worst=train.worst_leaves(program, reference),
             losses=program["losses"], reference_losses=reference["losses"])
        if i < args.faults:
            for side, kwargs in [("control_tf32", {"tf32": True})] + [
                    (f"fault_{f}", {"fault": f}) for f in FAULTS]:
                broken = follow(conf, mix, seed, "cuda", **kwargs)
                emit(seed=seed, side=side, **train.gaps(broken, reference),
                     worst=train.worst_leaves(broken, reference),
                     losses=broken["losses"])
        train.free("cuda")
    summary = {"workload": args.workload}
    for k in train.NUMBERS:
        summary[k] = {"lower": max(r[k] for r in lines if r["side"] == "program")}
        for side in sorted({r["side"] for r in lines} - {"program"}):
            summary[k][side] = min(r[k] for r in lines if r["side"] == side)
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps({"rows": lines, "summary": summary},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
