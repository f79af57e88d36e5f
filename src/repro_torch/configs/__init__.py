"""Architecture registry of the port: ``get_config(arch)`` /
``get_smoke_config(arch)``.

The config files are copies of ``repro/configs/<arch>.py`` (the JAX
files import ``repro.models``, which imports jax), with the same
``config()`` / ``smoke_config()`` values and ``SKIPS``: the dense and
MoE LMs, the four GNNs and DCN-v2.  ``shapes.py`` is a copy of the
reference's input-shape sets.
"""
from __future__ import annotations

import importlib

from .shapes import FAMILY_SHAPES

_MODULES = {
    "granite-8b": "granite_8b",
    "gemma2-27b": "gemma2_27b",
    "deepseek-7b": "deepseek_7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "gat-cora": "gat_cora",
    "gatedgcn": "gatedgcn",
    "graphsage-reddit": "graphsage_reddit",
    "graphcast": "graphcast",
    "dcn-v2": "dcn_v2",
}

ARCH_IDS = tuple(_MODULES)


def _mod(arch: str):
    try:
        name = _MODULES[arch]
    except KeyError as e:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(_MODULES)}"
                       ) from e
    return importlib.import_module(f".{name}", __package__)


def get_config(arch: str):
    return _mod(arch).config()


def get_smoke_config(arch: str):
    return _mod(arch).smoke_config()


def get_skips(arch: str) -> dict:
    return getattr(_mod(arch), "SKIPS", {})


def shapes_for(arch: str) -> dict:
    return FAMILY_SHAPES[get_config(arch).family]


def cells(include_skipped: bool = False):
    """All (arch, shape_name, skip reason or None) cells."""
    out = []
    for arch in ARCH_IDS:
        skips = get_skips(arch)
        for shape in shapes_for(arch):
            if shape in skips and not include_skipped:
                continue
            out.append((arch, shape, skips.get(shape)))
    return out
