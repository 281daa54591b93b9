"""Architecture registry (port of ``repro.configs``): all ten of the
reference's archs.  The dense ``qwen3_1_7b``, ``glm4_9b``,
``deepseek_coder_33b`` and ``h2o_danube_3_4b`` (a sliding window), the
moe ``granite_moe_1b_a400m`` and ``granite_moe_3b_a800m``, the ssm
``mamba2_780m``, the hybrid ``hymba_1_5b`` (a sliding window beside its
SSD), the encoder ``hubert_xlarge`` (no decode step) and the vlm
``llava_next_34b`` (decodes as dense).
"""
from __future__ import annotations

import importlib

ARCHS = ["qwen3_1_7b", "glm4_9b", "deepseek_coder_33b", "h2o_danube_3_4b",
         "granite_moe_1b_a400m", "granite_moe_3b_a800m", "mamba2_780m",
         "hymba_1_5b", "hubert_xlarge", "llava_next_34b"]

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def _module(name: str):
    name = _ALIASES.get(name, name)
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).SMOKE


def all_configs():
    return {a: get_config(a) for a in ARCHS}
