"""Continuous-batching serving engine: fixed-shape decode over cache lanes
(the counterpart of ``repro.launch.serve``; the scheduler half is
:mod:`repro_torch.sched.serving`).

Three ideas, as in the reference (vLLM/Orca-style), on the port's
cache/model contracts:

  * **One fixed-shape decode step, every batch composition.** The decode
    step runs over a fixed ``(max_batch, 1)`` token block with a position
    a lane and an activity mask: admitting or retiring a request changes
    *data*, never *shapes*. On the card each of the engine's three steps
    (decode, a prefill chunk, zeroing a lane) is captured **once** as a
    CUDA graph over static input buffers and replayed; a capture that fails
    raises, and nothing runs a step eagerly on the card instead. On the CPU
    the steps run eagerly. ``compile_count`` / ``prefill_compile_count`` /
    ``aux_compile_count`` count captures on the card and builds of the
    step on the CPU (the reference counts traces), and
    :func:`audit_serving_engine` holds them to one each.
  * **Chunked prefill.** A prompt of length P costs ``ceil(P/chunk)`` calls,
    each feeding ``chunk`` tokens through the family's own ``decode_step``
    (the reference's ``lax.scan``, unrolled); the padded tail of the last
    chunk is masked out of both cache and logits, which keeps generation
    token-identical to the token-by-token loop.
  * **Per-request cache lanes.** ``model.cache_specs(max_batch, max_seq)``
    is allocated once; requests are admitted onto free lanes mid-run,
    retired on EOS/max-tokens, and an evicted lane is zeroed before reuse
    (:func:`repro_torch.models.model.zero_cache_lane`: recurrent state is
    not self-masking the way attention caches are).

Decode is plain torch on the card, as it is XLA, not Pallas, in the
reference: no ported kernel runs on this path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_arch, list_archs
from repro_torch.models.model import (
    build_model,
    cache_lane,
    set_cache_lane,
    zero_cache_lane,
)
from repro_torch.training.train_step import make_serve_step

__all__ = [
    "Request",
    "ServingEngine",
    "audit_serving_engine",
    "greedy_generate",
    "greedy_generate_reference",
    "make_prefill_step",
    "serve_requests",
]


def _device_of(params) -> torch.device:
    leaf = params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.device


def _as_tokens(prompts, device) -> torch.Tensor:
    """(B, P) token ids, a tensor or array-like, as a long tensor on
    ``device``."""
    if not isinstance(prompts, torch.Tensor):
        prompts = torch.from_numpy(np.array(prompts, dtype=np.int64))
    return prompts.to(device=device, dtype=torch.long)


def _cast_like(new, old):
    """Each leaf of ``new`` in its ``old`` leaf's dtype (the reference's
    ``.astype(o.dtype)`` after its ``where``)."""
    return {k: v.to(old[k].dtype) for k, v in new.items()}


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------

def make_prefill_step(model) -> Callable:
    """(params, cache, tokens(B,C), pos0, n_total) -> (cache, last(B,Vp)).

    One call advances the whole batch through ``C`` prompt tokens: token
    ``tokens[:, i]`` at position ``pos0 + i`` through the family's own
    ``decode_step``. Steps with ``pos0 + i >= n_total`` (the zero-padded
    tail of a prompt's last chunk) are masked out of the cache update and
    the returned logits, so ``last`` is always the logits of the *last
    real* prompt token — the argmax seed of generation. ``pos0`` and
    ``n_total`` are ints or 0-d tensors on the cache's device.
    """

    def step(params, cache, tokens, pos0, n_total):
        b, c = tokens.shape
        device = tokens.device
        pos0 = torch.as_tensor(pos0, device=device)
        n_total = torch.as_tensor(n_total, device=device)
        last = torch.zeros((b, model.cfg.padded_vocab), dtype=torch.float32,
                           device=device)
        for i in range(c):
            valid = (pos0 + i) < n_total
            logits, new_cache = model.decode_step(
                params, cache, tokens[:, i:i + 1], pos0 + i,
                active=valid.expand(b))
            cache = _cast_like(new_cache, cache)
            last = torch.where(valid, logits[:, -1, :], last)
        return cache, last

    return step


def greedy_generate(model, params, prompts, max_new: int, max_seq: int, *,
                    prefill_chunk: int = 8) -> torch.Tensor:
    """Chunked prefill then greedy decode (token-identical to the
    token-by-token loop, at ``ceil(P/chunk)`` prefill calls instead of P).
    ``prompts`` (B, P) array-like; returns (B, P + max_new) on the
    parameters' device."""
    device = _device_of(params)
    prompts = _as_tokens(prompts, device)
    b, prompt_len = prompts.shape
    cache = model.steady_decode_cache(
        params, model.init_cache(b, max_seq, device))
    prefill = make_prefill_step(model)
    step = make_serve_step(model)
    c = max(1, int(prefill_chunk))
    last = None
    for c0 in range(0, prompt_len, c):
        chunk = prompts[:, c0:c0 + c]
        if chunk.shape[1] < c:
            chunk = torch.nn.functional.pad(chunk, (0, c - chunk.shape[1]))
        cache, last = prefill(params, cache, chunk, c0, prompt_len)
    if max_new <= 0:
        return prompts
    tok = torch.argmax(last[:, None, :], dim=-1)
    out = torch.cat([prompts, tok], dim=1)
    for t in range(prompt_len, prompt_len + max_new - 1):
        logits, cache = step(params, cache, tok, t)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out = torch.cat([out, tok], dim=1)
    return out


def greedy_generate_reference(model, params, prompts, max_new: int,
                              max_seq: int, *,
                              logits: Optional[list] = None) -> torch.Tensor:
    """The token-by-token loop (one step *per prompt token*), the
    regression oracle for the chunked path. The cache starts at the specs'
    dtypes and carries whatever dtypes the step returns, as the reference's
    loop does. ``logits``, if given, collects the (B, Vp) logits of every
    step that picks a generated token."""
    device = _device_of(params)
    prompts = _as_tokens(prompts, device)
    b, prompt_len = prompts.shape
    cache = model.init_cache(b, max_seq, device)
    step = make_serve_step(model)
    tok = prompts[:, :1]
    for t in range(prompt_len + max_new - 1):
        out, cache = step(params, cache, tok, t)
        if t + 1 < prompt_len:
            tok = prompts[:, t + 1:t + 2]
        else:
            if logits is not None:
                logits.append(out[:, -1])
            tok = torch.argmax(out[:, -1:], dim=-1)
            prompts = torch.cat([prompts, tok], dim=1)
    return prompts


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    """One generation request plus its lifecycle stamps.

    ``arrival`` is in engine-clock units (step calls — see
    :attr:`ServingEngine.clock`); :func:`serve_requests` holds a request
    back until the clock reaches it. The ``*_clock`` stamps are filled by
    the engine (TTFT = ``first_token_clock - arrival``, in clock ticks);
    the ``*_time`` stamps are wall seconds for throughput reporting only —
    nothing decision-making reads them.
    """

    id: int
    prompt: np.ndarray
    max_new: int
    eos_token: Optional[int] = None
    arrival: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)
    truncated: bool = False
    submit_clock: Optional[int] = None
    first_token_clock: Optional[int] = None
    done_clock: Optional[int] = None
    submit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    done_time: Optional[float] = None

    @property
    def ttft_clock(self) -> Optional[int]:
        if self.first_token_clock is None:
            return None
        return self.first_token_clock - self.arrival

    @property
    def tpot_clock(self) -> Optional[float]:
        """Mean clock ticks per generated token after the first."""
        if self.done_clock is None or len(self.tokens) < 2:
            return None
        return ((self.done_clock - self.first_token_clock)
                / (len(self.tokens) - 1))


class _FixedStep:
    """One fixed-shape step of an engine.

    On a CUDA device the step is captured once as a CUDA graph over static
    input buffers, after one warm-up run on a side stream with the ``idle``
    inputs (which leave the cache as it is), and every call copies its
    inputs into the buffers and replays the graph; a failed capture raises.
    On the CPU the step runs eagerly. ``on_build`` runs once: at the
    capture, or at the first CPU call."""

    def __init__(self, fn: Callable, idle: Sequence[torch.Tensor],
                 on_build: Callable[[], None]):
        self.fn = fn
        self.static = list(idle)
        self.on_build = on_build
        self.built = False
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None

    def __call__(self, *args: torch.Tensor):
        if self.static[0].device.type != "cuda":
            if not self.built:
                self.built = True
                self.on_build()
            return self.fn(*args)
        if self.graph is None:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.fn(*self.static)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.out = self.fn(*self.static)
            self.graph = graph
            self.on_build()
        for buf, a in zip(self.static, args):
            buf.copy_(a)
        self.graph.replay()
        return self.out


class ServingEngine:
    """Slot-based continuous batching over ``max_batch`` cache lanes.

    The decode step has fixed ``(max_batch, 1)`` shapes (free lanes
    masked); a prefill chunk fixed ``(1, prefill_chunk)`` shapes, its lane
    index, positions and valid length in static buffers; the zero-lane step
    a lane index. Each is captured once as a CUDA graph on the card (built
    once on the CPU): ``compile_count`` / ``prefill_compile_count`` /
    ``aux_compile_count`` count them, and ``STATIC_CLOSURE_ATTRS`` +
    :meth:`closure_fingerprint` guard what the steps close over — audited
    at runtime by :func:`audit_serving_engine`. The engine runs on the
    parameters' device.

    ``keep_logits`` maps request ids to lists that collect the request's
    logits: its prefill's last, then one per decode step (copies).
    """

    # attrs closed over by the fixed-shape steps: mutating any of them after
    # construction would silently desynchronize the captured graphs
    STATIC_CLOSURE_ATTRS = ("arch", "max_batch", "max_seq", "prefill_chunk")

    def __init__(self, model, params, *, max_batch: int, max_seq: int,
                 prefill_chunk: int = 8):
        self.model = model
        self.params = params
        self.arch = model.cfg.name
        self.max_batch = int(max_batch)
        self.max_seq = int(max_seq)
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.device = _device_of(params)
        # cast once to decode_step's dtype fixed point: the fixed-shape step
        # writes each leaf back into its buffer and must not round recurrent
        # state to the spec dtype every token
        self.cache = model.steady_decode_cache(
            params, model.init_cache(self.max_batch, self.max_seq, self.device))
        self.positions = np.zeros((self.max_batch,), np.int64)
        self.last_token = np.zeros((self.max_batch,), np.int64)
        self.active = np.zeros((self.max_batch,), bool)
        self.lane_req: List[Optional[Request]] = [None] * self.max_batch
        self.queue: Deque[Request] = deque()
        self.finished: List[Request] = []
        self.keep_logits: Dict[int, List[torch.Tensor]] = {}
        self.clock = 0          # decode/prefill calls so far
        self.decode_steps = 0
        self.compile_count = 0          # decode-step captures (pinned == 1)
        self.prefill_compile_count = 0
        self.aux_compile_count = 0      # zero-lane captures
        self._closure_fingerprint = self.closure_fingerprint()
        b, c = self.max_batch, self.prefill_chunk
        self._decode = self._fixed(self._make_decode(), "compile_count",
                                   self._ints(b, 1), self._ints(b),
                                   self._flags(b))
        self._prefill = self._fixed(self._make_prefill(),
                                    "prefill_compile_count", self._ints(1),
                                    self._ints(1, c), self._ints(),
                                    self._ints())
        self._zero = self._fixed(self._make_zero_lane(), "aux_compile_count",
                                 self._ints(1))

    def closure_fingerprint(self) -> tuple:
        return tuple(getattr(self, a) for a in self.STATIC_CLOSURE_ATTRS)

    # -- fixed-shape steps ---------------------------------------------------
    def _ints(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.long, device=self.device)

    def _flags(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.bool, device=self.device)

    def _fixed(self, fn, counter: str, *idle) -> _FixedStep:
        """``idle``: the warm-up inputs before a capture, all zeros: no lane
        active, no valid prefill position (n_total 0), and lane 0 for the
        zero step, whose first call comes at the first admission, onto lane
        0 of the still all-zero cache."""
        def built():
            setattr(self, counter, getattr(self, counter) + 1)

        return _FixedStep(fn, idle, built)

    def _make_decode(self):
        model, params, cache = self.model, self.params, self.cache

        def step(tokens, positions, active):
            logits, new_cache = model.decode_step_lanes(
                params, cache, tokens, positions, active)
            # free lanes are *masked*, not resized: their garbage decode
            # never lands in the cache, and the shapes never change
            for k, leaf in cache.items():
                if new_cache[k] is not leaf:
                    leaf.copy_(new_cache[k])
            last = logits[:, -1, :]
            return torch.argmax(last, dim=-1), last

        return step

    def _make_prefill(self):
        chunk_step = make_prefill_step(self.model)
        params, cache = self.params, self.cache

        def step(lane, tokens, pos0, n_total):
            one = cache_lane(cache, lane)
            one, last = chunk_step(params, one, tokens, pos0, n_total)
            set_cache_lane(cache, one, lane)
            return last[0]

        return step

    def _make_zero_lane(self):
        cache = self.cache

        def step(lane):
            zero_cache_lane(cache, lane)

        return step

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device)

    def graphs(self) -> Dict[str, Optional[torch.cuda.CUDAGraph]]:
        """The captured steps by name (None before a step's capture, and on
        the CPU). Replaying one repeats its last call: the decode step's
        rewrites each active lane's K/V with the same values, but advances
        recurrent state."""
        return {"decode": self._decode.graph, "prefill": self._prefill.graph,
                "zero": self._zero.graph}

    # -- request lifecycle ---------------------------------------------------
    def submit(self, req: Request) -> None:
        if len(req.prompt) >= self.max_seq:
            raise ValueError(
                f"request {req.id}: prompt of {len(req.prompt)} tokens "
                f"cannot fit a max_seq={self.max_seq} cache lane")
        req.submit_clock = self.clock
        req.submit_time = time.monotonic()
        self.queue.append(req)

    def free_lanes(self) -> int:
        return int(self.max_batch - self.active.sum())

    def admit(self, limit: Optional[int] = None) -> List[Request]:
        """Prefill queued requests onto free lanes (no drain: the running
        batch keeps its cache, new lanes join at the next decode step).
        ``limit`` caps admissions (for callers metering prefill work, e.g.
        a backend spending a slot's token budget); default: fill all lanes.
        """
        admitted: List[Request] = []
        while self.queue and not self.active.all():
            if limit is not None and len(admitted) >= limit:
                break
            lane = int(np.argmin(self.active))
            req = self.queue.popleft()
            # evict barrier: the lane may hold a retired request's
            # recurrent state — zero it before the new prompt conditions
            # on it (attention caches are self-masking, SSM/WKV state is not)
            lane_t = self._tensor([lane])
            self._zero(lane_t)
            prompt = np.asarray(req.prompt, np.int64)
            c = self.prefill_chunk
            n_total = self._tensor(len(prompt))
            last = None
            for c0 in range(0, len(prompt), c):
                chunk = prompt[c0:c0 + c]
                if len(chunk) < c:
                    chunk = np.pad(chunk, (0, c - len(chunk)))
                last = self._prefill(lane_t, self._tensor(chunk[None, :]),
                                     self._tensor(c0), n_total)
                self.clock += 1
            tok = int(torch.argmax(last))
            if req.id in self.keep_logits:
                self.keep_logits[req.id].append(last.clone())
            req.tokens.append(tok)
            req.first_token_clock = self.clock
            req.first_token_time = time.monotonic()
            if self._is_done(req, tok, len(prompt)):
                self._retire(req)
            else:
                self.lane_req[lane] = req
                self.positions[lane] = len(prompt)
                self.last_token[lane] = tok
                self.active[lane] = True
            admitted.append(req)
        return admitted

    def step(self) -> List[Request]:
        """One fixed-shape decode step over every lane; returns the requests
        that finished (EOS / max_new / cache-full) this step."""
        if not self.active.any():
            return []
        nxt, logits = self._decode(self._tensor(self.last_token[:, None]),
                                   self._tensor(self.positions),
                                   self._tensor(self.active))
        nxt = nxt.cpu().numpy()
        self.clock += 1
        self.decode_steps += 1
        done: List[Request] = []
        for lane in np.nonzero(self.active)[0]:
            req = self.lane_req[lane]
            tok = int(nxt[lane])
            if req.id in self.keep_logits:
                self.keep_logits[req.id].append(logits[lane].clone())
            req.tokens.append(tok)
            self.positions[lane] += 1
            self.last_token[lane] = tok
            if self._is_done(req, tok, int(self.positions[lane])):
                self.active[lane] = False
                self.lane_req[lane] = None
                self._retire(req)
                done.append(req)
        return done

    def _is_done(self, req: Request, tok: int, position: int) -> bool:
        if req.eos_token is not None and tok == req.eos_token:
            return True
        if len(req.tokens) >= req.max_new:
            return True
        if position >= self.max_seq:  # lane cache full: truncate
            req.truncated = True
            return True
        return False

    def _retire(self, req: Request) -> None:
        req.done_clock = self.clock
        req.done_time = time.monotonic()
        self.finished.append(req)

    @property
    def idle(self) -> bool:
        return not self.queue and not self.active.any()


def serve_requests(engine: ServingEngine, requests: Sequence[Request], *,
                   static: bool = False, max_steps: Optional[int] = None,
                   ) -> List[Request]:
    """Drive an engine over an arrival trace until every request finishes.

    ``static=True`` is the classic static-batching baseline: a new batch is
    admitted only once *every* lane has drained, so the batch runs at the
    pace of its longest request (the continuous path refills lanes the step
    they free up). Arrivals are in engine-clock units; when nothing is
    runnable yet the clock idles forward to the next arrival.
    """
    pending: Deque[Request] = deque(
        sorted(requests, key=lambda r: (r.arrival, r.id)))
    steps = 0
    while pending or engine.queue or engine.active.any():
        while pending and pending[0].arrival <= engine.clock:
            engine.submit(pending.popleft())
        if not static or not engine.active.any():
            engine.admit()
        if engine.active.any():
            engine.step()
        elif pending:
            engine.clock += 1  # idle tick: wait for the next arrival
        steps += 1
        if max_steps is not None and steps >= max_steps:
            break
    return engine.finished


def audit_serving_engine(engine: ServingEngine) -> List[str]:
    """Runtime audit of the engine's fixed-shape steps and lane invariants.
    Returns problem strings (empty = clean); read-only.

      * the decode step compiled (captured, or built on the CPU) at most
        once, and exactly once if any decode step ran — varying batch
        occupancy must not re-capture;
      * prefill/zero-lane steps likewise compiled at most once each (lane
        index, positions and valid lengths are static buffers' contents,
        not shapes);
      * the closed-over static attrs still match the construction-time
        fingerprint;
      * lane-table invariants: a request occupies at most one lane (no
        aliasing), every active lane has a request and an in-bounds
        position, every inactive lane is empty.
    """
    problems: List[str] = []
    if engine.decode_steps > 0 and engine.compile_count != 1:
        problems.append(
            f"decode step ran {engine.decode_steps}x but compiled "
            f"{engine.compile_count}x — the (max_batch, 1) shape contract "
            "is broken (occupancy must be data, not shape)")
    if engine.decode_steps == 0 and engine.compile_count > 1:
        problems.append(
            f"decode step compiled {engine.compile_count}x without running")
    if engine.prefill_compile_count > 1:
        problems.append(
            f"prefill chunk step compiled {engine.prefill_compile_count}x "
            "— lane/position/valid-length must be data, not shape")
    if engine.aux_compile_count > 1:
        problems.append(
            f"zero-lane step compiled {engine.aux_compile_count}x")
    fp = engine.closure_fingerprint()
    if fp != engine._closure_fingerprint:
        problems.append(
            f"closed-over static attrs {engine.STATIC_CLOSURE_ATTRS} "
            f"changed after construction ({engine._closure_fingerprint!r} "
            f"-> {fp!r}) — the captured steps are stale")
    seen = {}
    for lane, req in enumerate(engine.lane_req):
        if engine.active[lane]:
            if req is None:
                problems.append(f"active lane {lane} has no request")
                continue
            if id(req) in seen:
                problems.append(
                    f"request {req.id} aliased to lanes "
                    f"{seen[id(req)]} and {lane}")
            seen[id(req)] = lane
            if not 0 < engine.positions[lane] <= engine.max_seq:
                problems.append(
                    f"lane {lane} position {engine.positions[lane]} "
                    f"outside (0, {engine.max_seq}]")
        elif req is not None:
            problems.append(
                f"inactive lane {lane} still holds request {req.id} — "
                "evict must clear the lane table")
    return problems


# ---------------------------------------------------------------------------
# CLI demo
# ---------------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(
        description="Serve seeded requests on a reduced config through the "
                    "continuous-batching engine (the card by default).")
    p.add_argument("--arch", required=True, choices=list_archs())
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=8)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--chunk", type=int, default=8)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = get_arch(args.arch).reduced()
    model = build_model(cfg)
    params = model.init(0, device=args.device, dtype=torch.float32)
    rng = np.random.default_rng(1)
    engine = ServingEngine(model, params, max_batch=args.batch,
                           max_seq=args.prompt_len + args.max_new,
                           prefill_chunk=args.chunk)
    reqs = [Request(id=i,
                    prompt=rng.integers(0, cfg.vocab, args.prompt_len,
                                        dtype=np.int64),
                    max_new=args.max_new)
            for i in range(args.batch)]
    t0 = time.time()
    done = serve_requests(engine, reqs)
    dt = time.time() - t0
    toks = sum(len(r.tokens) for r in done)
    problems = audit_serving_engine(engine)
    if problems:
        raise RuntimeError("; ".join(problems))
    print(json.dumps({
        "arch": cfg.name,
        "device": str(engine.device),
        "requests": len(done),
        "tokens_per_s": round(toks / dt, 2),
        "decode_compiles": engine.compile_count,
        "sample": list(reqs[0].prompt) + reqs[0].tokens,
    }, default=int))


if __name__ == "__main__":
    main()
