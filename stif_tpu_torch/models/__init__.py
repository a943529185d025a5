"""Models of the port (counterparts of ``stif_tpu.models``)."""

from stif_tpu_torch.models.luna_tokis import LunaTokis

__all__ = ["LunaTokis"]
