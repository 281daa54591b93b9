"""Architecture registry (port of ``repro.configs``).

The four dense archs are ported (``qwen3_1_7b``, ``glm4_9b``,
``deepseek_coder_33b`` and ``h2o_danube_3_4b``, the last with a sliding
window); the reference's other six raise ``KeyError`` until their model
families are ported (ROADMAP.md, queue A item 11).
"""
from __future__ import annotations

import importlib

ARCHS = ["qwen3_1_7b", "glm4_9b", "deepseek_coder_33b", "h2o_danube_3_4b"]

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def _module(name: str):
    name = _ALIASES.get(name, name)
    if name not in ARCHS:
        raise KeyError(
            f"arch {name!r} is not ported to repro_torch yet (ported: "
            f"{ARCHS}); the rest follow ROADMAP.md queue A")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).SMOKE


def all_configs():
    return {a: get_config(a) for a in ARCHS}
