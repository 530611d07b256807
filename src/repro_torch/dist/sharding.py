"""Logical-axis sharding over a ``DeviceMesh`` for the GSPMD path (the
counterpart of ``repro.dist.sharding``).

Model code names *logical* axes ("embed", "heads", "batch", "act_embed",
...); a :class:`ShardingRules` maps each to zero or more *mesh* axes for the
current parallelism config. ``make_rules`` builds the reference's layouts
(TP over "model", DP over "pod"/"data", optional FSDP / sequence-parallel /
pure-DP / MoE-TP); callers may further mutate ``rules.rules`` (the dry run's
decode path reroutes "seq" when batch or kv_heads cannot shard).

A spec is the reference's ``PartitionSpec`` as a tuple: one entry a dim,
``None``, a mesh axis name or a tuple of names. :meth:`ShardingRules.
placements_for` turns one into DTensor placements, one a mesh dim: a dim
whose entry names a mesh axis is ``Shard(dim)`` on that mesh dim, every
other mesh dim is ``Replicate()``.

``constrain`` is a *contextual* sharding hint: inside ``with
activate(rules)`` it redistributes a DTensor to the rules' placements
(those of :meth:`ShardingRules.spec_for_shape`), and its gradient too;
outside, or on a tensor that is not a DTensor (one device, the explicit
ring path), it is the identity, so model code is written once for every
execution mode.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]


@dataclasses.dataclass
class ShardingRules:
    """Mesh + mutable logical-axis -> mesh-axis table."""

    mesh: DeviceMesh
    rules: Dict[str, MeshAxes]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names)

    def axis_size(self, name: str) -> int:
        return self.mesh.size(self.axis_names.index(name))

    def resolve(self, logical: Optional[str]) -> Tuple[str, ...]:
        """Mesh axes (possibly empty) for one logical axis name."""
        if logical is None:
            return ()
        target = self.rules.get(logical)
        if target is None:
            return ()
        if isinstance(target, str):
            target = (target,)
        return tuple(a for a in target if a in self.axis_names)

    def spec_for(self, axes: Sequence[Optional[str]]) -> Spec:
        """Spec entries for a tuple of logical axis names.

        A mesh axis may appear in at most one dim of a spec: the first
        logical axis to claim it wins (with "seq" rerouted to "model", a
        later "kv_heads" -> "model" entry degrades to replicated).
        """
        used: set = set()
        entries: List[MeshAxes] = []
        for logical in axes:
            mesh_axes = tuple(a for a in self.resolve(logical) if a not in used)
            used.update(mesh_axes)
            if not mesh_axes:
                entries.append(None)
            elif len(mesh_axes) == 1:
                entries.append(mesh_axes[0])
            else:
                entries.append(mesh_axes)
        return tuple(entries)

    def spec_for_shape(self, axes: Sequence[Optional[str]],
                       shape: Sequence[int]) -> Spec:
        """Like :meth:`spec_for` but a dim whose size does not divide by
        the product of its mesh axes degrades to replicated (kv_heads=2 on
        a 4-way "model" axis)."""
        entries: List[MeshAxes] = []
        for dim, entry in zip(shape, self.spec_for(axes)):
            ways = 1
            for a in _names(entry):
                ways *= self.axis_size(a)
            entries.append(entry if entry is not None and dim % ways == 0
                           else None)
        return tuple(entries)

    def placements(self, spec: Spec) -> Tuple[Placement, ...]:
        """One DTensor placement a mesh dim for a spec: ``Shard(i)`` on every
        mesh dim that tensor dim ``i``'s entry names, in mesh order."""
        out: List[Placement] = [Replicate()] * len(self.axis_names)
        for i, entry in enumerate(spec):
            for a in _names(entry):
                out[self.axis_names.index(a)] = Shard(i)
        return tuple(out)

    def placements_for(self, axes: Sequence[Optional[str]],
                       shape: Optional[Sequence[int]] = None
                       ) -> Tuple[Placement, ...]:
        """Placements of :meth:`spec_for` (or, given a shape,
        :meth:`spec_for_shape`)."""
        spec = self.spec_for(axes) if shape is None else self.spec_for_shape(axes, shape)
        return self.placements(spec)


def _names(entry: MeshAxes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_of(mesh: DeviceMesh, placements: Sequence[Placement],
             shape: Sequence[int]) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """This device's shard of a tensor of ``shape`` laid out by
    ``placements``: its local shape and its offset in the global tensor
    (``torch.chunk``'s split on every ``Shard`` mesh dim, in mesh order, as
    DTensor splits). Plain integers: no tensor is made, so it holds under
    ``FakeTensorMode`` too."""
    coord = mesh.get_coordinate()
    local, offset = list(shape), [0] * len(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            size = local[p.dim]
            chunk = -(-size // mesh.size(i))
            start = min(coord[i] * chunk, size)
            local[p.dim] = min(size, start + chunk) - start
            offset[p.dim] += start
    return tuple(local), tuple(offset)


def make_rules(mesh: DeviceMesh, *, fsdp: bool = False,
               sequence_parallel: bool = False, pure_dp: bool = False,
               moe_tp: bool = False) -> ShardingRules:
    """The reference's layouts over a ("pod",)("data", "model") mesh.

    Defaults: batch over the DP axes, TP (heads/mlp/vocab/experts) over
    "model". ``fsdp`` additionally shards the "embed" dim of every weight
    over the DP axes (ZeRO-3 style). ``sequence_parallel`` reroutes "seq" to
    "model". ``pure_dp`` disables TP and spreads batch over every mesh
    axis. ``moe_tp`` shards expert FFNs over their hidden dim instead of
    the expert dim.
    """
    names = tuple(mesh.mesh_dim_names)
    model = "model" if "model" in names else None
    dp_axes = tuple(a for a in ("pod", "data") if a in names)

    if pure_dp:
        batch: MeshAxes = tuple(a for a in ("pod", "data", "model")
                                if a in names) or None
        tp: MeshAxes = None
    else:
        batch = dp_axes or None
        tp = model

    rules: Dict[str, MeshAxes] = {
        # data / activation structure
        "batch": batch,
        "seq": tp if sequence_parallel else None,
        "act_embed": None,
        "act_heads": tp,
        "act_vocab": tp,
        # weight dims
        "layers": None,
        "head_dim": None,
        "frames": None,
        "embed": (dp_axes or None) if fsdp else None,
        "heads": tp,
        "kv_heads": tp,
        "mlp": tp,
        "vocab": tp,
        "ssm_heads": tp,
        # MoE: default experts over "model"; moe_tp moves the split to the
        # expert hidden dim (the dedupe in spec_for keeps one of them)
        "experts": None if moe_tp else tp,
        "moe_mlp": tp,
    }
    return ShardingRules(mesh=mesh, rules=rules)


def param_shardings(rules: ShardingRules, specs) -> Any:
    """Placements tree mirroring a (nested dict) ParamSpec tree."""
    if isinstance(specs, dict):
        return {k: param_shardings(rules, v) for k, v in specs.items()}
    return rules.placements_for(specs.axes, specs.shape)


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def attention_placements(q: DTensor, hkv: int
                         ) -> Tuple[List[Placement], bool]:
    """Placements for attention shard by shard, and whether k and v split
    as q does. q keeps its batch and head shards; a mesh dim that splits
    its sequence splits its heads instead (an all-to-all: the kernels take
    whole rows of keys and one query offset); every other dim is gathered
    and partial sums reduced. Heads that do not divide over their ways
    are gathered. k and v take q's placements where their kv heads divide
    over the same ways."""
    mesh, hq = q.device_mesh, q.shape[2]
    qp = [p if p.is_shard(0) or p.is_shard(2)
          else Shard(2) if p.is_shard(1) else Replicate() for p in q.placements]
    ways = 1
    for i, p in enumerate(qp):
        if p.is_shard(2):
            ways *= mesh.size(i)
    if hq % ways:
        qp = [Replicate() if p.is_shard(2) else p for p in qp]
        ways = 1
    return qp, (hkv % ways == 0)


def product_grads(a: Sequence[Placement], b: Sequence[Placement]
                  ) -> Tuple[List[Placement], List[Placement]]:
    """The gradient placements of a product's two operands, laid out as
    ``a`` and ``b``: each operand's gradient is a partial sum over the mesh
    dims that split the other operand alone, and is laid out as the
    operand elsewhere."""
    return ([Partial() if q.is_shard() and not p.is_shard() else p
             for p, q in zip(a, b)],
            [Partial() if p.is_shard() and not q.is_shard() else q
             for p, q in zip(a, b)])


def on_shards(fn, mesh: DeviceMesh, out, ins, grads=None):
    """``fn`` run on each device's local tensors (``local_map``), its DTensor
    inputs first redistributed to ``ins`` (one list of placements an input),
    its outputs laid out as ``out`` and its inputs' gradients as ``grads``
    (by default, as the inputs). The gradient of an output that is a
    partial sum is made whole on every device of those mesh dims first
    (:class:`_WholeGrad`)."""
    from torch.distributed.tensor.experimental import local_map

    mapped = local_map(fn, out_placements=out, in_placements=ins,
                       in_grad_placements=grads, device_mesh=mesh,
                       redistribute_inputs=True)
    single = out is not None and all(isinstance(p, Placement) for p in out)
    if out is None or not any(p.is_partial() for p in (
            out if single else [q for o in out if o is not None for q in o])):
        return mapped

    def run(*args):
        res = mapped(*args)
        if single:
            return _WholeGrad.apply(res)
        return tuple(_WholeGrad.apply(r) if isinstance(r, DTensor) else r
                     for r in res)

    return run


class _WholeGrad(torch.autograd.Function):
    """The identity, whose gradient is redistributed to the output's
    placements with each partial sum replaced by a replica: the gradient a
    partial sum takes. ``local_map`` would otherwise redistribute, say, a
    sequence-split gradient straight to a partial sum, which torch 2.11's
    DTensor does not do."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = [Replicate() if p.is_partial() else p
                          for p in x.placements]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if not isinstance(g, DTensor) or list(g.placements) == ctx.placements:
            return g
        return g.redistribute(g.device_mesh, ctx.placements)


def like(ref: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t``, a plain tensor every device holds whole (positions, masks,
    rotary tables), as a replicated DTensor on ``ref``'s mesh when ``ref``
    is a DTensor; itself otherwise."""
    if not isinstance(ref, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def whole_seq(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its sequence (dim 1) whole on every device: a DTensor's
    split of it is gathered (what a token shift or a causal conv needs: the
    rows before each); anything else is returned as it is."""
    if not isinstance(x, DTensor) or not any(p.is_shard(1) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_shard(1) else p
                                          for p in x.placements])


# -- contextual activation constraints --------------------------------------

_active = threading.local()


def current_rules() -> Optional[ShardingRules]:
    return getattr(_active, "rules", None)


@contextlib.contextmanager
def activate(rules: ShardingRules):
    """Make ``constrain`` redistribute DTensors to the rules' placements."""
    prev = current_rules()
    _active.rules = rules
    try:
        yield rules
    finally:
        _active.rules = prev


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]]) -> torch.Tensor:
    """Sharding hint on an intermediate; identity outside ``activate`` or on
    a tensor that is not a DTensor."""
    rules = current_rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    assert len(axes) == x.ndim, (axes, x.shape)
    # the shape's spec, not the reference's spec_for: GSPMD pads a dim that
    # does not divide, and DTensor cannot reshape such a shard
    spec = rules.spec_for_shape(axes, x.shape)
    if all(e is None for e in spec):
        return x  # a fully replicated hint adds nothing
    return _Constrain.apply(x, rules.placements(spec))


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to ``placements``, and so is its gradient:
    as the transpose of ``with_sharding_constraint`` is the same constraint
    on the cotangent. (DTensor's own ``redistribute`` hands a partial-sum
    gradient back unreduced, and the next product then gathers weights
    rather than reduce it.)"""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None
