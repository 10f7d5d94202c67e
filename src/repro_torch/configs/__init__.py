"""Architecture registry: ``--arch <id>`` resolution for the LM launchers
and the dry run.

Each module defines ``CONFIG`` (the exact public configuration) and ``SMOKE``
(a reduced same-family variant for CPU tests), field for field the
reference's (``repro.configs``).
"""

from __future__ import annotations

import importlib

from ..models.config import SHAPES, ModelConfig, input_specs  # noqa: F401

_MODULES = {
    "mamba2-130m": "mamba2_130m",
    "qwen2.5-3b": "qwen2_5_3b",
    "internlm2-20b": "internlm2_20b",
    "stablelm-12b": "stablelm_12b",
    "granite-8b": "granite_8b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "arctic-480b": "arctic_480b",
    "internvl2-26b": "internvl2_26b",
    "whisper-base": "whisper_base",
    "recurrentgemma-9b": "recurrentgemma_9b",
}

ARCHS = tuple(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"{__name__}.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE


def cells(include_skips: bool = False):
    """All (arch, shape) dry-run cells; skipped cells annotated with reason."""
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        skips = cfg.shape_skips()
        for shape in SHAPES:
            if shape in skips and not include_skips:
                continue
            out.append((arch, shape, skips.get(shape)))
    return out
