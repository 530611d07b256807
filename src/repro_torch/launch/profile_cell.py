"""Per-op profile of one dry-run cell (the counterpart of
``repro.launch.profile_cell``; run standalone, it starts the fake world).

Usage: PYTHONPATH=src python -m repro_torch.launch.profile_cell \\
           --arch granite-3-2b --shape train_4k [--metric bytes|flops|wire] [--multi-pod]
"""

import argparse

from repro_torch.configs import SHAPES, list_archs
from repro_torch.launch.dryrun import record_cell
from repro_torch.launch.mesh import start_fake_world


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True, choices=list_archs())
    p.add_argument("--shape", required=True, choices=list(SHAPES))
    p.add_argument("--metric", default="bytes", choices=["bytes", "flops", "wire"])
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--fsdp", default=None, type=lambda s: s == "1")
    args = p.parse_args()

    mesh_name = "2x16x16" if args.multi_pod else "16x16"
    print(f"[profile] fake mesh {mesh_name}: no device is used; every rank is "
          "a placeholder of one process (fake process group, fake tensors)",
          flush=True)
    start_fake_world(512 if args.multi_pod else 256)
    model = record_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                        fsdp=args.fsdp)[0]
    total = model.entry_cost()
    val = {"bytes": total.bytes, "flops": total.flops,
           "wire": total.total_wire_bytes}[args.metric]
    print(f"total {args.metric}: {val:.3e}")
    for r in model.top_ops(args.top, metric=args.metric):
        print(f"  {r['total']:<10.3e} x{r['mult']:<6.0f} {r['opcode']:<22s} "
              f"{r['type']:<52s} {r['op_name']}")


if __name__ == "__main__":
    main()
