"""Assigned-architecture configs, the data of the reference's
``repro.configs``.  ``get(name)`` returns the full config,
``get_reduced(name)`` the CPU-smoke-sized one.  ``ARCHS`` lists all ids.
Every config is here, and the model zoo's port serves each of them."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced

ARCHS = [
    "olmo_1b", "qwen2_7b", "stablelm_3b", "stablelm_1_6b",
    "recurrentgemma_9b", "kimi_k2_1t_a32b", "arctic_480b",
    "internvl2_2b", "rwkv6_3b", "hubert_xlarge",
]

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}
_ALIASES.update({
    "olmo-1b": "olmo_1b", "qwen2-7b": "qwen2_7b",
    "stablelm-3b": "stablelm_3b", "stablelm-1.6b": "stablelm_1_6b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b", "arctic-480b": "arctic_480b",
    "internvl2-2b": "internvl2_2b", "rwkv6-3b": "rwkv6_3b",
    "hubert-xlarge": "hubert_xlarge",
})


def _module(name: str):
    return importlib.import_module(
        f"repro_torch.configs.{_ALIASES.get(name, name)}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    mod = _module(name)
    if hasattr(mod, "REDUCED"):
        return mod.REDUCED
    return reduced(mod.CONFIG)
