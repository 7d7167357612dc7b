"""Config registry: ``get_config(name)`` / ``smoke_config(name)``.

``ARCHS`` lists the models the port builds, every arch of
``repro.configs``: the dense, MoE and MLA LMs, whisper-base and
llama-3.2-vision-11b (which the serving launcher refuses: they need audio
frames or image patches, as in repro), and the recurrent families,
zamba2-2.7b (Mamba2 with a shared attention block) and rwkv6-3b (Finch),
which the launcher serves through the bucket engine. ``beanna-mnist`` is
the paper's MLP (core/hybrid_mlp.py), which is trained and run, not served.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (SHAPES, ModelConfig, PrecisionPolicy, ShapeSpec,  # noqa: F401
                                     cell_is_runnable)

ARCHS = ["stablelm-3b", "minicpm3-4b", "deepseek-v2-236b", "qwen3-8b", "qwen2-72b",
         "whisper-base", "llama-3.2-vision-11b", "deepseek-v3-671b", "zamba2-2.7b",
         "rwkv6-3b"]

_MOD = {"stablelm-3b": "stablelm_3b", "minicpm3-4b": "minicpm3_4b",
        "deepseek-v2-236b": "deepseek_v2_236b", "qwen3-8b": "qwen3_8b",
        "qwen2-72b": "qwen2_72b", "whisper-base": "whisper_base",
        "llama-3.2-vision-11b": "llama32_vision_11b",
        "deepseek-v3-671b": "deepseek_v3_671b", "zamba2-2.7b": "zamba2_2p7b",
        "rwkv6-3b": "rwkv6_3b", "beanna-mnist": "beanna_mnist"}


def _module(name: str):
    if name not in _MOD:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MOD)}")
    return importlib.import_module(f"repro_torch.configs.{_MOD[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()
