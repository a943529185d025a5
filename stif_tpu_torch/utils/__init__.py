"""Host-side utilities of the port (counterpart of ``stif_tpu.utils``)."""

from stif_tpu_torch.utils.misc import AverageMeter, ProgressBar

__all__ = ["AverageMeter", "ProgressBar"]
