"""Training of the port (counterpart of ``stif_tpu.train``)."""

from stif_tpu_torch.train.losses import (charbonnier_loss, lap_loss,
                                         make_pixel_criterion)
from stif_tpu_torch.train.schedules import (cosine_annealing_restart,
                                            multistep_restart, warmup_wrap)

__all__ = [
    "charbonnier_loss",
    "lap_loss",
    "make_pixel_criterion",
    "cosine_annealing_restart",
    "multistep_restart",
    "warmup_wrap",
]
