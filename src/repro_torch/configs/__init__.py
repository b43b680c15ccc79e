"""Architecture registry: ``--arch <id>`` resolution for every launcher.

A copy of ``repro.configs`` (the ten assigned architectures) that loads no
JAX; ``tests/test_torch_configs.py`` holds every copy equal to the original.
``get_config`` returns the full config, ``get_smoke`` the reduced
same-family config used by CPU tests.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig

_MODULES = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "minicpm3-4b": "minicpm3_4b",
    "glm4-9b": "glm4_9b",
    "internlm2-1.8b": "internlm2_1_8b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "musicgen-medium": "musicgen_medium",
    "internvl2-1b": "internvl2_1b",
    "xlstm-125m": "xlstm_125m",
    "zamba2-7b": "zamba2_7b",
}

ALL_ARCHS = tuple(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG.validate()


def get_smoke(name: str) -> ArchConfig:
    return _module(name).SMOKE.validate()


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def runnable_cells() -> list[tuple[str, str]]:
    """The 40 assigned (arch x shape) cells, minus documented long_500k
    skips for pure full-attention archs (DESIGN.md §5)."""
    cells = []
    for arch in ALL_ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not cfg.subquadratic:
                continue  # documented skip: dense KV/quadratic attention
            cells.append((arch, shape.name))
    return cells


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ALL_ARCHS for s in SHAPES]
