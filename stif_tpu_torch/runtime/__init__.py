"""Serving runtime of the port (counterpart of ``stif_tpu.runtime``)."""

from stif_tpu_torch.runtime.chunked import ChunkedDecoder
from stif_tpu_torch.runtime.eval import (
    EvalResult,
    eval_adobe_4x,
    eval_adobe_liif4x,
    eval_adobe_tmnet,
    eval_space_time_sr,
    eval_temporal_x8,
    eval_vid4_tmnet,
)
from stif_tpu_torch.runtime.pipeline import (
    InferencePipeline,
    pad_to_multiple,
    window_plan,
)

__all__ = [
    "ChunkedDecoder",
    "EvalResult",
    "InferencePipeline",
    "eval_adobe_4x",
    "eval_adobe_liif4x",
    "eval_adobe_tmnet",
    "eval_space_time_sr",
    "eval_temporal_x8",
    "eval_vid4_tmnet",
    "pad_to_multiple",
    "window_plan",
]
