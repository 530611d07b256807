"""Plain PyTorch pieces that the references share: the weights drawn from a
seed, norms, the head and loss, and the ring's walk that every wire
(``perfbench/reference/wires/``) sends its messages over.

Nothing here imports the program. Matrix products run in f32 with TF32 off
unless a control asks for TF32 (:func:`precision`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

# (path, shape, init, std): init is "normal" (N(0, std)), "ones" or "zeros"
Layout = List[Tuple[str, Tuple[int, ...], str, float]]


def precision(tf32: bool) -> None:
    """Matrix products in f32 (``tf32=False``) or in TF32, process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def padded_vocab(s: Dict) -> int:
    """The vocabulary rounded up to a multiple of ``vocab_padding`` rows, as
    the embedding and the head are laid out."""
    pad = s["vocab_padding"]
    return -(-s["vocab_size"] // pad) * pad


def fan_in_std(shape: Sequence[int]) -> float:
    """``1 / sqrt(fan_in)``, fan-in the second-to-last dim (the last for a
    vector)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return 1.0 / math.sqrt(max(int(fan_in), 1))


def draw(layout: Layout, seed: int, device) -> Dict[str, torch.Tensor]:
    """f32 weights of ``layout`` from ``seed``: every normal leaf a slice of
    one ``randn`` call on ``device``'s generator, scaled in place."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    total = sum(math.prod(shape) for _, shape, init, _ in layout
                if init == "normal")
    flat = torch.randn(total, generator=gen, dtype=torch.float32, device=device)
    out, at = {}, 0
    for path, shape, init, std in layout:
        if init == "normal":
            n = math.prod(shape)
            out[path] = flat[at:at + n].view(shape).mul_(std)
            at += n
        elif init == "ones":
            out[path] = torch.ones(shape, dtype=torch.float32, device=device)
        else:
            out[path] = torch.zeros(shape, dtype=torch.float32, device=device)
    return out


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """``{"a/b": t}`` as ``{"a": {"b": t}}``."""
    out: Dict = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def norm(t: torch.Tensor, rows: int = 1 << 24) -> float:
    """The 2-norm of ``t``, its squares summed in f64 a slice at a time."""
    flat = t.detach().reshape(-1)
    total = 0.0
    for at in range(0, flat.numel(), rows):
        total += float(torch.sum(torch.square(flat[at:at + rows].double())))
    return total ** 0.5


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def shift(x: torch.Tensor) -> torch.Tensor:
    """x one step later along the sequence (dim 1), zeros first."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def lm_loss(h: torch.Tensor, head: torch.Tensor, vocab: int,
            labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy of ``h @ head`` over the first
    ``vocab`` columns (the rest are padding and take no probability)."""
    logits = (h @ head)[..., :vocab].reshape(-1, vocab)
    labels = labels.long().reshape(-1, 1)
    return torch.mean(torch.logsumexp(logits, dim=-1, keepdim=True)
                      - torch.gather(logits, -1, labels))


# -- the ring's reduction ----------------------------------------------------

def ring_walk(grads: Sequence[torch.Tensor], encode: Callable, decode: Callable,
              block: Optional[int] = None) -> torch.Tensor:
    """The sum of ``w`` ranks' tensors as a ring forms it, every rank
    getting the same. Chunk ``j`` starts at rank ``j`` and gathers rank
    ``j + 1``'s, then ``j + 2``'s, ... as it travels the ring: each hop
    sends ``encode`` of its partial sum, and the next rank adds its own
    chunk to ``decode`` of it; the finished chunk is sent, ``encode``-d,
    once more. ``encode`` and ``decode`` take and give ``(rows, block)``
    f32 tensors, a chunk padded to whole blocks of ``min(block, chunk)``
    elements (one block a chunk when ``block`` is None)."""
    w = len(grads)
    shape, n = grads[0].shape, grads[0].numel()
    if w == 1:
        return grads[0].clone()
    c = -(-n // w)
    b = c if block is None else max(1, min(block, c))
    c = -(-c // b) * b
    flat = torch.zeros((w, w * c), dtype=torch.float32, device=grads[0].device)
    for r, g in enumerate(grads):
        flat[r, :n] = g.reshape(-1)
    chunks = flat.view(w, w, c)                  # [rank, chunk, elements]
    out = torch.empty((w, c), dtype=torch.float32, device=flat.device)
    for j in range(w):
        rows = chunks[:, j].reshape(w, -1, b)
        msg = encode(rows[j])
        for t in range(1, w - 1):
            msg = encode(rows[(j + t) % w] + decode(msg))
        reduced = rows[(j - 1) % w] + decode(msg)
        out[j] = decode(encode(reduced)).reshape(-1)
    return out.reshape(-1)[:n].reshape(shape)
