"""The port's logical-axis sharding (``repro_torch.dist.sharding``) against
the reference's (``repro.dist.sharding``).

For every leaf of the ten configs' parameter trees, on the 16x16, 2x16x16
and 2x4 meshes, under ``make_rules``' five layouts (default, ``fsdp``,
``sequence_parallel``, ``pure_dp``, ``moe_tp``): the port's ``spec_for``
and ``spec_for_shape`` entries equal the reference's over a
``jax.sharding.AbstractMesh`` (no devices), and the local shape of the
port's ``placements_for`` equals ``NamedSharding(...).shard_shape``.
``spec_tree_axes`` is equal across the packages, and ``constrain`` is the
identity outside ``activate`` and on plain tensors, and gives the rules'
placements inside.

The port's side needs a process group as large as each mesh: it runs in a
subprocess (this file run as a script) that starts a ``fake`` world of 512
ranks and writes its specs as JSON.
"""

import json
import os
import subprocess
import sys

import pytest
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import get_arch as jax_get_arch
from repro.configs import list_archs
from repro.dist.sharding import make_rules as jax_make_rules
from repro.models.model import build_model as jax_build_model
from repro.models.module import _flatten as jax_flatten
from repro.models.module import spec_tree_axes as jax_spec_tree_axes

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
LAYOUTS = {"default": {}, "fsdp": {"fsdp": True},
           "sequence_parallel": {"sequence_parallel": True},
           "pure_dp": {"pure_dp": True}, "moe_tp": {"moe_tp": True}}
WORLD = 512


def _entry(e):
    """A spec entry as JSON gives it back: None, a name or a tuple."""
    return tuple(e) if isinstance(e, list) else e


def port_side(path: str) -> None:
    """The port's specs, local shapes and axes for every mesh, layout,
    config and leaf, and the ``constrain`` checks, as JSON at ``path``."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    from repro_torch.configs import get_arch, list_archs as archs
    from repro_torch.dist import sharding as S
    from repro_torch.launch.mesh import start_fake_world
    from repro_torch.models.model import build_model
    from repro_torch.models.module import _flatten, spec_tree_axes

    start_fake_world(WORLD)
    out = {"specs": {}, "axes": {}}
    meshes = {}
    for name, (shape, names) in MESHES.items():
        n = 1
        for d in shape:
            n *= d
        meshes[name] = DeviceMesh("cpu", torch.arange(n).reshape(shape),
                                  mesh_dim_names=names)
    for arch in archs():
        specs = build_model(get_arch(arch)).param_specs()
        out["axes"][arch] = {p: list(a) for p, a in spec_tree_axes(specs).items()}
        for mname, mesh in meshes.items():
            for lname, flags in LAYOUTS.items():
                rules = S.make_rules(mesh, **flags)
                rows = {}
                for leaf, spec in _flatten(specs):
                    entries = rules.spec_for_shape(spec.axes, spec.shape)
                    local, _ = S.shard_of(mesh, rules.placements_for(
                        spec.axes, spec.shape), spec.shape)
                    rows[leaf] = {"spec_for": list(rules.spec_for(spec.axes)),
                                  "spec_for_shape": list(entries),
                                  "local": list(local)}
                out["specs"][f"{mname}|{lname}|{arch}"] = rows

    mesh = meshes["2x4"]
    rules = S.make_rules(mesh)
    x = torch.zeros(8, 6, 4, 2)
    axes = ("batch", None, "act_heads", None)
    xd = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    checks = {"plain_outside": S.constrain(x, axes) is x,
              "dtensor_outside": S.constrain(xd, axes) is xd}
    with S.activate(rules):
        y = S.constrain(xd, axes)
        checks["plain_inside"] = S.constrain(x, axes) is x
        checks["replicated_hint"] = S.constrain(xd, (None, None, None, None)) is xd
        checks["inside_placements"] = [str(p) for p in y.placements]
        checks["want_placements"] = [str(p) for p in rules.placements(
            rules.spec_for_shape(axes, x.shape))]
        checks["inside_is_dtensor"] = isinstance(y, DTensor)
    checks["active_after"] = S.current_rules() is None
    out["constrain"] = checks
    with open(path, "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sharding") / "port.json")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, __file__, path], check=True, env=env,
                   timeout=600)
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_specs_and_shard_shapes_match_reference(port, mesh_name, layout):
    shape, names = MESHES[mesh_name]
    mesh = AbstractMesh(shape, names)
    rules = jax_make_rules(mesh, **LAYOUTS[layout])
    n_leaves = 0
    for arch in list_archs():
        got = port["specs"][f"{mesh_name}|{layout}|{arch}"]
        specs = jax_build_model(jax_get_arch(arch)).param_specs()
        for path, spec in jax_flatten(specs):
            row = got[path]
            want_shape = rules.spec_for_shape(spec.axes, spec.shape)
            assert tuple(map(_entry, row["spec_for"])) == tuple(
                rules.spec_for(spec.axes)), (arch, path)
            assert tuple(map(_entry, row["spec_for_shape"])) == tuple(want_shape), \
                (arch, path)
            assert tuple(row["local"]) == tuple(
                NamedSharding(mesh, want_shape).shard_shape(spec.shape)), (arch, path)
            n_leaves += 1
        assert set(got) == {p for p, _ in jax_flatten(specs)}
    assert n_leaves > 100


@pytest.mark.parametrize("arch", list_archs())
def test_spec_tree_axes_match_reference(port, arch):
    want = jax_spec_tree_axes(jax_build_model(jax_get_arch(arch)).param_specs())
    got = port["axes"][arch]
    assert {p: tuple(a) for p, a in got.items()} == {p: tuple(a) for p, a in want.items()}


def test_constrain_identity_outside_and_placements_inside(port):
    c = port["constrain"]
    assert c["plain_outside"] and c["dtensor_outside"] and c["plain_inside"]
    assert c["replicated_hint"] and c["inside_is_dtensor"] and c["active_after"]
    # batch over "data", heads over "model" on the 2x4 mesh
    assert c["inside_placements"] == c["want_placements"] == ["S(0)", "S(2)"]


if __name__ == "__main__":
    port_side(sys.argv[1])
