"""Named spans of the training path, for a profiler to read.

``span(name, *counts)`` opens ``repro_torch::<name>`` as a function-scope
range of the profiler, carrying ``counts`` (ints) as its inputs: with
``record_shapes=True`` they come out as the event's concrete inputs. A
function-scope range, unlike ``torch.profiler.record_function``'s
user-scope one, has no image on the device's timeline, so a span adds no
device activity to a trace. Without an active profiler ``span`` returns one
shared no-op context and builds nothing.

The spans, outermost first (each nests in the one above it):

* ``slot.form`` (``ElasticTrainer.run_slot``): the ring formed and the
  state resharded;
* ``step`` (``run_slot``): one step, from its batch to the loss read;
* ``step.batch`` (``run_slot``): the global batch and its shards;
* ``step.grads`` (``train_step.rank_grads``): one rank's loss and
  gradients;

  * ``hybrid.shared`` (``models/ssm.py`` ``Zamba2LM._shared_use``): one use
    of a published Zamba2 shared block, from the concatenation to the use's
    ``linear``; ``block`` and ``use``, its indices;
  * ``mamba.layer`` (``models/ssm.py`` ``_mamba_layer``): one Mamba2 layer;
    ``layer``, its index. A remat recompute in backward enters it again, on
    the autograd engine's thread;

* ``step.reduce`` (``train_step.reduce_grads``, ``ef_reduce_grads``): the
  ring's reduction of every rank's gradients;
* ``ring.layout`` (``dist/collectives.py`` ``_ring_chunks``): the f32
  ring's taking of one call's chunks, before its hops and beside them, not
  around them (once a leaf in mode ``ring``); ``viewed`` and ``copied``, the
  bytes taken as views of the ranks' own tensors and the bytes put in
  padded copies, each summed over the ranks;
* ``fused.layout`` (``dist/compression.py`` ``_fused_ring_all_reduce``):
  the fused int8/fp8 ring's taking of one call's chunks and gather
  buffers, before its hops (once a leaf in the fused quantized modes);
  ``in_place`` and ``copied``, the bytes of the call's wire messages that
  the kernel making each wrote where it crosses the wire and the reader
  read where it landed, and the bytes that went through a copy, each
  summed over the ranks;
* ``ring.hop`` (``LocalRing.permute``): one ppermute; ``bytes``, what it
  adds to ``LocalRing.bytes`` summed over the ranks;
* ``step.update`` (``make_ring_train_step``): the optimizer on each
  device's replica.
"""

from __future__ import annotations

import contextlib

import torch
from torch._C._profiler import _RecordFunctionFast

PREFIX = "repro_torch::"
OFF = contextlib.nullcontext()


def span(name: str, *counts: int):
    """The span ``repro_torch::<name>`` with ``counts`` as its inputs, or
    :data:`OFF` when no profiler is active."""
    if not torch.autograd._profiler_enabled():
        return OFF
    return _RecordFunctionFast(PREFIX + name, input_values=list(counts))
