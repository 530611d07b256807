"""Model protocol + dispatcher (the counterpart of ``repro.models.model``).

Every family implements ``param_specs()`` and ``forward(params, batch)``;
``init`` and ``loss`` are shared. Decode and its cache come with serving.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.module import SpecTree, init_from_specs


class BaseModel:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg

    def param_specs(self) -> SpecTree:
        raise NotImplementedError

    def forward(self, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def init(self, seed: int = 0, *, device="cuda", dtype=None):
        """Parameters drawn from a ``torch.Generator`` on ``device`` seeded
        with ``seed``. Torch's draws differ from ``jax.random``'s: to start
        from the reference's weights use ``params_from_reference``."""
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return init_from_specs(self.param_specs(), gen, device, dtype=dtype)

    def loss(self, params, batch) -> torch.Tensor:
        logits, aux = self.forward(params, batch)
        ce = cross_entropy(logits, batch["labels"])
        return ce + 0.01 * aux.get("moe_aux", 0.0)


def masked_lm_head(h, w, vocab: int):
    """Logits over the padded vocab with pad slots masked to -inf (exact CE
    under Megatron-style vocab padding)."""
    logits = torch.einsum("bsd,dv->bsv", h, w)
    vp = w.shape[-1]
    if vp == vocab:
        return logits
    mask = torch.arange(vp, device=logits.device) < vocab
    return torch.where(mask[None, None, :], logits,
                       torch.tensor(-1e30, dtype=logits.dtype, device=logits.device))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy; labels are pre-shifted by the pipeline."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def build_model(cfg: ArchConfig) -> BaseModel:
    from repro_torch.models import transformer

    if cfg.family == "dense":
        return transformer.DenseLM(cfg)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported to repro_torch yet")
