"""Serving runtime of the port (counterpart of ``stif_tpu.runtime``)."""

from stif_tpu_torch.runtime.pipeline import (
    InferencePipeline,
    pad_to_multiple,
    window_plan,
)

__all__ = ["InferencePipeline", "pad_to_multiple", "window_plan"]
