"""Architecture registry of the port.

Each ported arch module defines CONFIG (the published configuration,
field for field as in the JAX package) and SMOKE (a reduced config of
the same family for CPU tests).  This slice ports the serving path of
the two archs below; every other arch raises.
"""
from __future__ import annotations

import importlib

PORTED = ("qwen3_1_7b", "mamba2_1_3b")


def canon(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(arch: str, smoke: bool = False):
    name = canon(arch)
    if name not in PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP Queue 1); the port "
            f"has {', '.join(PORTED)}")
    mod = importlib.import_module(f"{__name__}.{name}")
    return mod.SMOKE if smoke else mod.CONFIG
