"""Architecture registry of the port: ``get_config(arch)`` /
``get_smoke_config(arch)``.

The three dense LMs are copies of ``repro/configs/<arch>.py`` (the JAX
files import ``repro.models.transformer``, which imports jax), with the
same ``config()`` / ``smoke_config()`` values.  The MoE ids are known
but not ported yet; the other families (GNN, recsys) are not LMs.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "granite-8b": "granite_8b",
    "gemma2-27b": "gemma2_27b",
    "deepseek-7b": "deepseek_7b",
}
_NOT_PORTED = ("qwen2-moe-a2.7b", "granite-moe-3b-a800m")

ARCH_IDS = tuple(_MODULES)


def _mod(arch: str):
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch}: MoE LMs are not ported yet (ROADMAP §1, "
            "models/moe.py)")
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
