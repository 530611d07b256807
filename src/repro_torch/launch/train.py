"""End-to-end training entry point (the counterpart of ``repro.launch.train``).

Trains a config with explicit ring-all-reduce data parallelism: every rank
of the ring runs in this process, by default all on the first CUDA card.

Examples:
  python -m repro_torch.launch.train --arch qwen3-0.6b --mode compressed-fused --dp 4
  python -m repro_torch.launch.train --device cpu --arch qwen3-0.6b --reduced --steps 4
"""

from __future__ import annotations

import argparse
import json
import time

from repro_torch.configs import get_arch, list_archs
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models.model import build_model
from repro_torch.training.elastic import ElasticTrainer, SlotPlan
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.train_step import RING_STEP_MODES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True, choices=list_archs())
    p.add_argument("--reduced", action="store_true",
                   help="train the reduced (CPU-sized) config")
    p.add_argument("--device", default="cuda",
                   help="device every rank runs on (default: cuda)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--dp", type=int, default=0,
                   help="ring size (0 = all rank slots)")
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--mode", default="ring", choices=RING_STEP_MODES)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--log-every", type=int, default=10)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    data = SyntheticTokens(cfg.vocab, args.seq, args.global_batch)
    opt = make_optimizer(cfg.optimizer)
    trainer = ElasticTrainer(model, opt, data,
                             global_batch=args.global_batch,
                             base_lr=args.lr, mode=args.mode,
                             checkpoint_dir=args.checkpoint_dir,
                             device=args.device)
    if args.checkpoint_dir:
        trainer.restore()
    dp = args.dp or len(trainer.group.devices)
    t0 = time.time()
    done = 0
    while done < args.steps:
        chunk = min(args.log_every, args.steps - done)
        res = trainer.run_slot(SlotPlan(workers=dp, steps=chunk))
        done += chunk
        dt = time.time() - t0
        print(f"step {trainer.step:5d} loss {res['loss']:.4f} "
              f"dp={res.get('workers', dp)} {done / dt:.2f} steps/s",
              flush=True)
    print(json.dumps({
        "final_step": trainer.step,
        "final_loss": trainer.losses[-1],
        "first_loss": trainer.losses[0],
        "mode": args.mode,
    }))


if __name__ == "__main__":
    main()
