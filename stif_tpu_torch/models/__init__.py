"""Models of the port (counterparts of ``stif_tpu.models``)."""

from stif_tpu_torch.models.luna_tokis import LunaTokis
from stif_tpu_torch.models.luna_tokis_variants import (
    LunaTokisNoFlow,
    LunaTokisS,
    LunaTokisTrain,
    LunaTokisZSM,
)
from stif_tpu_torch.models.tmnet import TMNet
from stif_tpu_torch.models import ablations as _ablations  # registers LIIF_*
from stif_tpu_torch.models.registry import make_model, register_model
from stif_tpu_torch.nn.mlp import MLP

register_model("mlp")(MLP)

__all__ = [
    "LunaTokis",
    "LunaTokisTrain",
    "LunaTokisZSM",
    "LunaTokisS",
    "LunaTokisNoFlow",
    "TMNet",
    "MLP",
    "register_model",
    "make_model",
]
