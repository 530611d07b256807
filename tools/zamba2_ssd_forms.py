#!/usr/bin/env python3
"""How far zamba2-1.2b's losses move with the form of its SSD, on one CUDA card.

Run from the root of a checkout: ``python3 tools/zamba2_ssd_forms.py``. It
needs one card and ``nvcc``, and builds the kernels as ``chip_smoke.py``
does. At full width and full depth, from ``model.init(0)``, it measures:

- the loss of rank 0's shard of the first batch through the SSD kernels
  and through each exact form of the SSD: the model's plain
  ``ssd_chunked`` at chunks 256 (the model's), 128 and 64, and the
  kernels' plain version in f64 at chunks 64 and 256 (the same function to
  f64 rounding);
- ``chip_smoke.PLAN`` in the f32 ``ring`` mode twice, through the kernels
  and with the SSD through the plain ``ssd_chunked`` on the card
  (autograd's backward), every loss of each (the steps', then the held-out
  and the slot's first batch before and after) and their gaps.

The spread of the first losses is what the rest of the model makes of a
reordering of the SSD's sums; the gaps are what training makes of it. This
is why ``chip_smoke.py`` holds the kernels call by call on the Zamba2 path
rather than its slot against the plain-SSD slot. The last line of the
output is the result as JSON.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch.models import ssm as ssm_model  # noqa: E402


@torch.no_grad()
def first_losses(model, data) -> dict:
    """The loss of rank 0's shard of the first batch at ``model.init(0)``
    through the kernels and through each exact form of the SSD."""
    cfg = model.cfg
    params = model.init(0, device=C.DEVICE, dtype=torch.float32)
    batch = {k: torch.as_tensor(v)[:C.GLOBAL_BATCH // 4].to(C.DEVICE)
             for k, v in data.batch(0).items()}
    kernel = ssm_model.ssd_scan

    # each route takes ssd_scan's arguments, the state last (None here), and
    # gives (y, final state)
    def chunked(chunk):
        return lambda *a, state=None: ssm_model.ssd_chunked(*a, chunk,
                                                            initial_state=state)

    def plain_f64(chunk):
        def route(*a, state=None):
            y, _, final = C.SSD.ssd_scan_plain(*(t.double() for t in a), state,
                                               chunk=chunk)
            return y.float(), final.float()
        return route

    routes = {"kernels": kernel, "ssd_chunked 256": chunked(cfg.ssm_chunk),
              "ssd_chunked 128": chunked(128), "ssd_chunked 64": chunked(64),
              **{f"plain f64 {c}": plain_f64(c)
                 for c in (C.SSD.SSD_CHUNK, cfg.ssm_chunk)}}
    out = {}
    try:
        for name, route in routes.items():
            ssm_model.ssd_scan = route
            out[name] = float(model.loss(params, batch))
    finally:
        ssm_model.ssd_scan = kernel
    return out


def slot_values(model, data, plain: bool) -> dict:
    """``chip_smoke.ring_slot``'s slot through the kernels, or with the SSD
    through the plain ``ssd_chunked``; its losses, and B9's launches."""
    kernel = ssm_model.ssd_scan
    if plain:
        ssm_model.ssd_scan = lambda x, dt, A, Bm, Cm, state=None: ssm_model.ssd_chunked(
            x, dt, A, Bm, Cm, model.cfg.ssm_chunk, initial_state=state)
    try:
        trainer, _, evals, seconds, _, launches = C.ring_slot(model, data)
    finally:
        ssm_model.ssd_scan = kernel
    values = (trainer.losses + list(evals["heldout"])
              + list(evals["first_batch"]))
    del trainer
    C.free_cuda()
    return {"values": values, "slot_s": seconds,
            "b9_launches": {k: launches[k] for k in C.SSD.LAUNCHES}}


def main() -> int:
    if not torch.cuda.is_available():
        print("zamba2_ssd_forms: this needs a CUDA card", file=sys.stderr)
        return 1
    card = C.card_line()
    C.log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    C.build.build_all()
    cfg = C.get_arch(C.ZAMBA_ARCH)
    model = C.build_model(cfg)
    data = C.SyntheticTokens(cfg.vocab, C.SEQ, C.GLOBAL_BATCH, seed=0)
    firsts = first_losses(model, data)
    C.log(f"the first loss through each form of the SSD: {firsts}")
    C.free_cuda()
    slots = {"kernels": slot_values(model, data, plain=False),
             "plain ssd_chunked": slot_values(model, data, plain=True)}
    if any(slots["plain ssd_chunked"]["b9_launches"].values()) or not all(
            slots["kernels"]["b9_launches"].values()):
        raise AssertionError(f"B9's launches: {slots}")
    gaps = [abs(a - b) for a, b in zip(slots["kernels"]["values"],
                                       slots["plain ssd_chunked"]["values"])]
    C.log(f"the slot through the kernels and through the plain SSD: {slots}; "
          f"gaps {gaps}")
    print(card, flush=True)
    print(json.dumps({"first_loss_by_ssd_form": firsts,
                      "first_loss_spread": max(firsts.values()) - min(firsts.values()),
                      "slots": slots, "gaps": gaps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
