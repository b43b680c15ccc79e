"""The port's copies of the config schema and the ten architecture configs
equal the JAX package's, field by field."""

import dataclasses

import pytest

from repro import configs as jax_configs
from repro.models import config as jax_config
from repro_torch import configs
from repro_torch.models import config


def test_same_architectures():
    assert configs.ALL_ARCHS == jax_configs.ALL_ARCHS
    assert len(configs.ALL_ARCHS) == 10


@pytest.mark.parametrize("arch", jax_configs.ALL_ARCHS)
def test_config_and_smoke_equal_reference(arch):
    for port, ref in ((configs.get_config(arch), jax_configs.get_config(arch)),
                      (configs.get_smoke(arch), jax_configs.get_smoke(arch))):
        assert type(port).__name__ == type(ref).__name__
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.resolved_head_dim == ref.resolved_head_dim
        assert port.q_per_kv == ref.q_per_kv
        assert config.count_params(port) == jax_config.count_params(ref)
        assert config.active_params(port) == jax_config.active_params(ref)


def test_schema_fields_and_shapes_equal_reference():
    for name in ("ArchConfig", "MoEConfig", "MLAConfig", "SSMConfig", "ShapeConfig"):
        port, ref = getattr(config, name), getattr(jax_config, name)
        assert [(f.name, f.default) for f in dataclasses.fields(port)] == [
            (f.name, f.default) for f in dataclasses.fields(ref)
        ]
    assert {k: dataclasses.asdict(v) for k, v in config.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jax_config.SHAPES.items()
    }


def test_validate_raises_like_reference():
    bad = dict(n_heads=3, n_kv_heads=2)
    with pytest.raises(ValueError):
        jax_configs.get_smoke("internlm2-1.8b").scaled(**bad).validate()
    with pytest.raises(ValueError):
        configs.get_smoke("internlm2-1.8b").scaled(**bad).validate()
