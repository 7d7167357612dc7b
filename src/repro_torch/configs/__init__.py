"""Config registry: ``get_config(name)`` / ``smoke_config(name)``.

``ARCHS`` lists the models the port builds (the launchers' choices; the
serving launcher refuses whisper-base and llama-3.2-vision-11b, which need
audio frames or image patches, as repro's does); ``beanna-mnist`` is the
paper's MLP (core/hybrid_mlp.py), which is trained and run, not served.
The other archs of ``repro.configs`` raise NotImplementedError naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, PrecisionPolicy  # noqa: F401

ARCHS = ["stablelm-3b", "minicpm3-4b", "deepseek-v2-236b", "qwen3-8b", "qwen2-72b",
         "whisper-base", "llama-3.2-vision-11b", "deepseek-v3-671b"]

_MOD = {"stablelm-3b": "stablelm_3b", "minicpm3-4b": "minicpm3_4b",
        "deepseek-v2-236b": "deepseek_v2_236b", "qwen3-8b": "qwen3_8b",
        "qwen2-72b": "qwen2_72b", "whisper-base": "whisper_base",
        "llama-3.2-vision-11b": "llama32_vision_11b",
        "deepseek-v3-671b": "deepseek_v3_671b", "beanna-mnist": "beanna_mnist"}

# archs of the JAX package that this package does not build yet
_LATER = {name: "ROADMAP A8 part 3 (the recurrent families)" for name in (
    "zamba2-2.7b", "rwkv6-3b")}


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
