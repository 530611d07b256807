"""The port's rings (``repro_torch.dist``) held against the JAX package's
``ring_all_reduce`` and ``compressed_ring_all_reduce(fused=True)``.

The JAX references run under ``jax.shard_map(..., check_vma=False)`` on w
host devices, all in one subprocess (this file run as a script) that
writes ``.npz``; ``check_vma=False`` is what the reference's own trainer
passes (a Pallas call under ``shard_map`` fails the default check on
jax 0.9). The port runs the same w ranks in this process over a
:class:`LocalRing` on the CPU, where the quant-ring wrappers take their
plain versions.

Tolerances:
  * the f32 ring keeps the reference's hop order, so its sums are
    bit-identical;
  * the fused int8 ring may differ where XLA's CPU backend contracts
    ``acc + q * scale`` into an FMA (the port never does): one ulp of a
    partial sum can move a requantized code by one step at each of the
    w-2 Share-Reduce requantizations and the final quantization, so at
    most w-1 steps of the final block scale are allowed. Measured on these
    inputs: a block scale one ulp apart (at most 1.4e-5 of a step) in every
    case, and besides that two elements one full step apart at w=3, d=513.
"""

import os
import subprocess
import sys
from functools import partial

import numpy as np
import pytest
import torch

from repro.core.rar_model import wire_formula
from repro_torch.dist.collectives import LocalRing, ring_all_reduce, ring_wire_elements
from repro_torch.dist.compression import (
    _fused_chunk_layout,
    compressed_ring_all_reduce,
    compressed_ring_ppermutes,
    compressed_wire_bytes,
)

BLOCK = 128
WS = (2, 3, 4)
SIZES = (513, 1000)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _key(w, d):
    return f"w{w}_d{d}"


def _inputs():
    rng = np.random.default_rng(11)
    return {_key(w, d): rng.standard_normal((w, d)).astype(np.float32)
            for w in WS for d in SIZES}


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring_ref")
    np.savez(tmp / "in.npz", **_inputs())
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), str(tmp / "in.npz"),
         str(tmp / "out.npz")],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(tmp / "out.npz") as f:
        return dict(f)


def _ranks(x):
    return [torch.from_numpy(x[r].copy()) for r in range(x.shape[0])]


@pytest.mark.parametrize("d", SIZES)
@pytest.mark.parametrize("w", WS)
def test_f32_ring_bit_identical_to_reference(jax_out, w, d):
    x = _inputs()[_key(w, d)]
    ring = LocalRing(["cpu"] * w)
    out = ring_all_reduce(_ranks(x), ring)
    want = jax_out["ring_" + _key(w, d)]
    for r in range(w):
        np.testing.assert_array_equal(out[r].numpy(), want[r])
    # wire: 2(w-1) messages of the zero-padded ceil(d/w) chunk per rank
    d_wire = -(-d // w) * w
    assert ring.messages == [2 * (w - 1)] * w
    assert ring.bytes == [4 * ring_wire_elements(d_wire, w)] * w
    assert ring.bytes == [wire_formula(None).bytes_per_worker(d, w)] * w


@pytest.mark.parametrize("d", SIZES)
@pytest.mark.parametrize("w", WS)
def test_fused_ring_matches_reference(jax_out, w, d):
    x = _inputs()[_key(w, d)]
    ring = LocalRing(["cpu"] * w)
    out = compressed_ring_all_reduce(_ranks(x), ring, fused=True,
                                     block=BLOCK)
    got = np.stack([o.numpy() for o in out])
    want = jax_out["fused_" + _key(w, d)]
    # every rank ends bit-identical, in the port and in the reference
    assert (got == got[0]).all() and (want == want[0]).all()
    # at most w-1 int8 steps of the final block scale off the reference
    # (max |block| = 127 * scale exactly: the amax element codes to +-127)
    c_pad, nb, pad = _fused_chunk_layout(d, w, BLOCK)
    blocks = np.pad(want[0], (0, pad)).reshape(w * nb, c_pad // nb)
    step = np.abs(blocks).max(axis=1, keepdims=True) / 127.0
    tol = np.broadcast_to((w - 1) * step * (1 + 1e-6), blocks.shape)
    tol = tol.reshape(-1)[:d]
    assert (np.abs(got[0] - want[0]) <= tol).all()
    # the reference's accuracy bound against the exact sum
    exact = x.sum(axis=0)
    rel = np.abs(got[0] - exact).max() / (np.abs(exact).max() + 1e-9)
    assert rel < 0.15, rel
    # LocalRing's own counts equal the wire accounting of both packages
    msgs = compressed_ring_ppermutes(w, fused=True)
    nbytes = compressed_wire_bytes(d, w, fused=True, block=BLOCK)
    f = wire_formula("int8-fused", block=BLOCK)
    assert ring.messages == [msgs] * w and msgs == f.messages(w)
    assert ring.bytes == [nbytes] * w and nbytes == f.bytes_per_worker(d, w)


def test_one_rank_rings_pass_through():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(77)
                         .astype(np.float32))
    ring = LocalRing(["cpu"])
    for fused in (True, False):
        assert torch.equal(compressed_ring_all_reduce([x], ring, fused=fused)[0], x)
    assert torch.equal(ring_all_reduce([x], ring)[0], x)
    assert ring.messages == [0] and ring.bytes == [0]
    # the unfused ring over two ranks: two messages per hop, ranks agree
    ring2 = LocalRing(["cpu"] * 2)
    out = compressed_ring_all_reduce([x, x], ring2)
    assert torch.equal(out[0], out[1])
    assert ring2.messages == [compressed_ring_ppermutes(2)] * 2 == [4, 4]
    assert ring2.bytes == [compressed_wire_bytes(77, 2)] * 2


def _jax_reference(inp, out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.dist.collectives import ring_all_reduce as jax_ring
    from repro.dist.compression import compressed_ring_all_reduce as jax_fused

    fns = {"ring": jax_ring,
           "fused": partial(jax_fused, fused=True, block=BLOCK, interpret=True)}
    res = {}
    with np.load(inp) as data:
        for key in data.files:
            x = data[key]
            mesh = Mesh(np.array(jax.devices()[: x.shape[0]]), ("d",))
            for name, fn in fns.items():
                f = jax.jit(jax.shard_map(
                    lambda a, fn=fn: fn(a[0], axis_name="d")[None], mesh=mesh,
                    in_specs=P("d", None), out_specs=P("d", None),
                    check_vma=False))
                res[f"{name}_{key}"] = np.asarray(f(jnp.asarray(x)))
    np.savez(out, **res)


if __name__ == "__main__":
    _jax_reference(sys.argv[1], sys.argv[2])
