"""The port's ten architecture configs, its model dispatch and its abstract
inputs and parameters held against the JAX package's: every field of every
config and of its reduced form, every parameter count, ``build_model``'s
family table, and ``input_specs`` / ``abstract_params`` (``meta`` tensors in
the port where the reference gives ``ShapeDtypeStruct``s) at full size."""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_arch as jax_get_arch
from repro.configs import list_archs as jax_list_archs
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import SHAPES, get_arch, list_archs
from repro_torch.models.encdec import WhisperLM
from repro_torch.models.model import build_model
from repro_torch.models.module import _flatten
from repro_torch.models.moe_model import MoeLM
from repro_torch.models.rwkv import Rwkv6LM
from repro_torch.models.ssm import Mamba2LM, Zamba2LM
from repro_torch.models.transformer import DenseLM

ARCHS = jax_list_archs()
# the reference's parameter counts of the configs this slice adds
PARAM_COUNTS = {"phi3.5-moe-42b": 41_873_051_648,
                "arctic-480b": 476_850_275_328,
                "whisper-large-v3": 1_603_788_800,
                "internvl2-26b": 19_862_722_560,
                "phi3-medium-14b": 14_659_507_200}
FAMILY_CLASS = {"dense": DenseLM, "vlm": DenseLM, "moe": MoeLM,
                "hybrid": Zamba2LM, "ssm": Mamba2LM, "rwkv": Rwkv6LM,
                "encdec": WhisperLM}


def test_the_reference_ten_are_registered():
    assert len(ARCHS) == 10
    assert list_archs() == ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_count_match_reference(arch):
    for reduced in (False, True):
        ref, cfg = jax_get_arch(arch), get_arch(arch)
        if reduced:
            ref, cfg = ref.reduced(), cfg.reduced()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        assert cfg.n_params() == ref.n_params()
    if arch in PARAM_COUNTS:
        assert get_arch(arch).n_params() == PARAM_COUNTS[arch]


@pytest.mark.parametrize("family", sorted(FAMILY_CLASS))
def test_build_model_covers_every_family(family):
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").reduced(), family=family)
    assert type(build_model(cfg)) is FAMILY_CLASS[family]
    assert type(jax_build_model(dataclasses.replace(
        jax_get_arch("qwen3-0.6b").reduced(), family=family))).__name__ == \
        FAMILY_CLASS[family].__name__


def _meta(tree):
    return {p: (tuple(v.shape), str(v.dtype).split(".")[1], v.device.type)
            for p, v in _flatten(tree)}


def _structs(tree):
    return {p: (tuple(v.shape), jnp.dtype(v.dtype).name, "meta")
            for p, v in _flatten(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    model, jmodel = build_model(cfg), jax_build_model(jcfg)
    assert cfg.supported_shapes() == jcfg.supported_shapes()
    for name in cfg.supported_shapes():
        assert dataclasses.asdict(SHAPES[name]) == dataclasses.asdict(JAX_SHAPES[name])
        got, want = model.input_specs(SHAPES[name]), jmodel.input_specs(
            JAX_SHAPES[name])
        assert all(isinstance(v, torch.Tensor) for _, v in _flatten(got))
        assert _meta(got) == _structs(want), name


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_reference(arch):
    model, jmodel = build_model(get_arch(arch)), jax_build_model(jax_get_arch(arch))
    assert _meta(model.abstract_params()) == _structs(jmodel.abstract_params())
    assert _meta(model.abstract_params(torch.float32)) == \
        _structs(jmodel.abstract_params(jnp.float32))
