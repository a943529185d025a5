"""Network modules of the port (counterparts of ``stif_tpu.nn``)."""

from stif_tpu_torch.nn.blocks import Conv, ResidualBlockNoBN, ResidualTrunk, lrelu
from stif_tpu_torch.nn.convlstm import (
    BiDeformableConvLSTM,
    ConvLSTMCell,
    DeformableConvLSTM,
)
from stif_tpu_torch.nn.dcn import DCNSep
from stif_tpu_torch.nn.mlp import MLP
from stif_tpu_torch.nn.pcd import EasyPCD, PCDAlign
from stif_tpu_torch.nn.siren import Siren

__all__ = [
    "BiDeformableConvLSTM",
    "Conv",
    "ConvLSTMCell",
    "DCNSep",
    "DeformableConvLSTM",
    "EasyPCD",
    "MLP",
    "PCDAlign",
    "ResidualBlockNoBN",
    "ResidualTrunk",
    "Siren",
    "lrelu",
]
