"""Config registry: ``get_config(name)`` / ``smoke_config(name)``.

``ARCHS`` lists the LMs the port can serve (the serving launcher's
choices); ``beanna-mnist`` is the paper's MLP (core/hybrid_mlp.py), which
is trained and run, not served. The other archs of ``repro.configs`` raise
NotImplementedError naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, PrecisionPolicy  # noqa: F401

ARCHS = ["stablelm-3b"]

_MOD = {"stablelm-3b": "stablelm_3b", "beanna-mnist": "beanna_mnist"}

# archs of the JAX package that this package does not serve yet
_LATER = {name: "ROADMAP A8 (the other model families)" for name in (
    "minicpm3-4b", "qwen3-8b", "qwen2-72b", "whisper-base", "llama-3.2-vision-11b",
    "deepseek-v2-236b", "deepseek-v3-671b", "zamba2-2.7b", "rwkv6-3b")}


def _module(name: str):
    if name in _LATER:
        raise NotImplementedError(f"arch {name!r} is not ported yet: {_LATER[name]}")
    if name not in _MOD:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MOD)}")
    return importlib.import_module(f"repro_torch.configs.{_MOD[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()
