"""Architecture + shape configuration system.

Every assigned architecture registers an :class:`ArchConfig` here (exact
public config) plus a ``reduced()`` variant for CPU smoke tests. The four
input shapes are global; per-arch applicability (e.g. ``long_500k`` only for
sub-quadratic archs) is encoded in :meth:`ArchConfig.supported_shapes`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import InitVar
from typing import Dict, List, Optional, Tuple

_REGISTRY: Dict[str, "ArchConfig"] = {}
# ArchConfig's init-only settings, in their order
_INIT_ONLY = ("ssm_groups", "hybrid_layers", "n_shared_blocks", "adapter_rank", "norm_eps")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # attention variants
    qk_norm: bool = False
    sliding_window: Optional[int] = None   # SWA width (h2o-danube)
    rope_theta: float = 10000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_dff: int = 0                 # expert hidden size (d_ff used for dense path)
    dense_residual: bool = False     # arctic: dense MLP in parallel with MoE
    moe_capacity: float = 1.25       # capacity factor (tokens dropped beyond)
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # hybrid (zamba2)
    attn_every: int = 0              # shared attention block period
    # enc-dec (whisper)
    n_enc_layers: int = 0
    n_frames: int = 0                # precomputed frame embeddings (stub frontend)
    # vlm (internvl2)
    n_patches: int = 0               # precomputed patch embeddings (stub frontend)
    # rwkv6
    rwkv_head_dim: int = 64
    # training / lowering knobs
    remat: bool = True
    scan_layers: bool = True
    optimizer: str = "adamw"         # "adamw" | "adafactor"
    # parallelism defaults (overridable by launch flags)
    fsdp: bool = False               # shard params over the data axis (ZeRO-3)
    sequence_parallel: bool = False  # shard activations on seq (train too)
    notes: str = ""
    # Mamba2's B/C groups and the published Zamba2 block (Zamba2-7B,
    # modeling_zamba2.py; models/ssm.py's Zamba2LM): init-only variables,
    # kept as attributes by __post_init__ and carried by dataclasses.replace,
    # but not fields, so that the registered configs' fields stay the JAX
    # package's one for one (``as_dict``, ``==``, ``hash`` and ``repr`` take
    # them in). With ``hybrid_layers`` (the published ids) a shared block is
    # used before each of those Mamba layers, ``n_shared_blocks`` of them in
    # turn, reading concat(h, embedding) (attention width 2 d_model), its
    # output through the use's own LoRA and ``linear`` added to that Mamba
    # layer's input before its norm, not to the residual; () keeps
    # ``attn_every``'s block (zamba2-1.2b).
    ssm_groups: InitVar[int] = 1           # head h reads B/C group h // (heads / groups)
    hybrid_layers: InitVar[Tuple[int, ...]] = ()
    n_shared_blocks: InitVar[int] = 1      # shared blocks, used in turn (num_mem_blocks)
    adapter_rank: InitVar[int] = 0         # per-use LoRA rank on the shared MLP's gate and up
    norm_eps: InitVar[float] = 1e-6        # RMS norms' epsilon (Mamba2 and Zamba2 models)

    def __post_init__(self, ssm_groups, hybrid_layers, n_shared_blocks,
                      adapter_rank, norm_eps):
        for name, value in zip(_INIT_ONLY, (ssm_groups, hybrid_layers, n_shared_blocks,
                                            adapter_rank, norm_eps)):
            object.__setattr__(self, name, value)

    def as_dict(self) -> Dict[str, object]:
        """Every setting, the init-only ones too: ``ArchConfig(**c.as_dict())
        == c`` (``dataclasses.asdict`` leaves them out)."""
        return {**dataclasses.asdict(self), **{k: getattr(self, k) for k in _INIT_ONLY}}

    def _key(self) -> tuple:
        return tuple((k, tuple(v) if isinstance(v, list) else v)
                     for k, v in self.as_dict().items())

    def __eq__(self, other):
        if other.__class__ is not self.__class__:
            return NotImplemented
        return self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return "ArchConfig(" + ", ".join(f"{k}={v!r}" for k, v in self.as_dict().items()) + ")"

    # -- derived -----------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128 so embedding/lm_head shard
        cleanly 16-way (standard Megatron-style vocab padding). Pad logits
        are masked to -inf before the softmax, so the CE is exact."""
        return ((self.vocab + 127) // 128) * 128

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attn_width(self) -> int:
        """The shared block's input width: concat(h, embedding) in the
        published Zamba2 block, else d_model."""
        return 2 * self.d_model if self.hybrid_layers else self.d_model

    @property
    def attention_free(self) -> bool:
        return self.family in ("ssm",) and self.attn_every == 0

    def subquadratic(self) -> bool:
        """Eligible for long_500k: SSM / hybrid / sliding-window attention."""
        return (
            self.family in ("ssm", "hybrid", "rwkv")
            or self.sliding_window is not None
        )

    def supported_shapes(self) -> List[str]:
        out = ["train_4k", "prefill_32k", "decode_32k"]
        if self.subquadratic():
            out.append("long_500k")
        return out

    def n_params(self) -> int:
        """Analytical parameter count (cross-checked in tests vs spec trees)."""
        from repro_torch.models.model import build_model
        from repro_torch.models.module import n_params as count

        return count(build_model(self).param_specs())

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 2 if self.attn_every == 0 else max(2, self.attn_every)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256,
            vocab=512,
            n_experts=min(self.n_experts, 4),
            moe_dff=128 if self.n_experts else 0,
            # no token dropping at smoke scale: keeps decode == forward exact
            moe_capacity=8.0 if self.n_experts else 1.25,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=32,
            attn_every=2 if self.attn_every else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_frames=min(self.n_frames, 16),
            n_patches=min(self.n_patches, 8),
            rwkv_head_dim=32,
            remat=False,
        )


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> List[str]:
    return sorted(_REGISTRY)
