"""Model registry (port of ``stif_tpu/models/registry.py``)."""

from __future__ import annotations

_MODELS = {}


def register_model(name: str):
    def deco(cls):
        _MODELS[name] = cls
        return cls

    return deco


def make_model(name: str, **kwargs):
    if name not in _MODELS:
        raise KeyError(f"unknown model '{name}'; have {sorted(_MODELS)}")
    return _MODELS[name](**kwargs)
