"""PCD (pyramid, cascading, deformable) alignment (port of
``stif_tpu/nn/pcd.py``): three-level alignment in both directions with six
DCN_sep; coarser offsets are bilinearly upsampled x2 and scaled x2. The JAX
package's grouped ``_fused`` form is the same maths arranged for the TPU;
this is the two-direction form."""

from __future__ import annotations

import torch
import torch.nn as nn

from stif_tpu_torch.nn.blocks import Conv, lrelu
from stif_tpu_torch.nn.dcn import DCNSep
from stif_tpu_torch.ops.resize import resize_bilinear


def _up2(x: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(x, scale_factor=2, align_corners=False)


class PCDAlign(nn.Module):
    def __init__(self, nf: int = 64, groups: int = 8, gather_dtype=None):
        super().__init__()
        for s in ("1", "2"):
            for lvl in ("L3", "L2", "L1"):
                setattr(self, f"{lvl}_offset_conv1_{s}", Conv(2 * nf, nf))
                setattr(self, f"{lvl}_dcnpack_{s}",
                        DCNSep(nf, nf, deformable_groups=groups,
                               gather_dtype=gather_dtype))
            setattr(self, f"L3_offset_conv2_{s}", Conv(nf, nf))
            for lvl in ("L2", "L1"):
                setattr(self, f"{lvl}_offset_conv2_{s}", Conv(2 * nf, nf))
                setattr(self, f"{lvl}_offset_conv3_{s}", Conv(nf, nf))
                setattr(self, f"{lvl}_fea_conv_{s}", Conv(2 * nf, nf))

    def forward(self, fea1, fea2) -> torch.Tensor:
        """fea1, fea2: [L1, L2, L3] NHWC pyramids. Returns (B, H, W, 2*nf):
        both directions' aligned L1 features, concatenated."""
        outs = []
        for s, a, b in (("1", fea1, fea2), ("2", fea2, fea1)):
            def m(name):
                return getattr(self, f"{name}_{s}")

            # L3
            off = lrelu(m("L3_offset_conv1")(torch.cat([a[2], b[2]], -1)))
            off = lrelu(m("L3_offset_conv2")(off))
            l3_fea = lrelu(m("L3_dcnpack")(a[2], off))
            l3_off = off
            # L2
            off = lrelu(m("L2_offset_conv1")(torch.cat([a[1], b[1]], -1)))
            off = lrelu(m("L2_offset_conv2")(
                torch.cat([off, _up2(l3_off) * 2], -1)))
            off = lrelu(m("L2_offset_conv3")(off))
            l2_fea = m("L2_dcnpack")(a[1], off)
            l2_fea = lrelu(m("L2_fea_conv")(
                torch.cat([l2_fea, _up2(l3_fea)], -1)))
            l2_off = off
            # L1
            off = lrelu(m("L1_offset_conv1")(torch.cat([a[0], b[0]], -1)))
            off = lrelu(m("L1_offset_conv2")(
                torch.cat([off, _up2(l2_off) * 2], -1)))
            off = lrelu(m("L1_offset_conv3")(off))
            l1_fea = m("L1_dcnpack")(a[0], off)
            # the final fea conv has no activation
            outs.append(m("L1_fea_conv")(
                torch.cat([l1_fea, _up2(l2_fea)], -1)))
        return torch.cat(outs, -1)


class EasyPCD(nn.Module):
    """Build L2/L3 pyramids of two single-level maps, align, fuse 1x1."""

    def __init__(self, nf: int = 64, groups: int = 8, gather_dtype=None):
        super().__init__()
        self.fea_L2_conv1 = Conv(nf, nf, 3, 2, 1)
        self.fea_L2_conv2 = Conv(nf, nf, 3, 1, 1)
        self.fea_L3_conv1 = Conv(nf, nf, 3, 2, 1)
        self.fea_L3_conv2 = Conv(nf, nf, 3, 1, 1)
        self.pcd_align = PCDAlign(nf, groups, gather_dtype)
        self.fusion = Conv(2 * nf, nf, 1, 1, 0)

    def forward(self, f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
        x = torch.cat([f1, f2], 0)  # the pair stacked on the batch axis
        l2 = lrelu(self.fea_L2_conv2(lrelu(self.fea_L2_conv1(x))))
        l3 = lrelu(self.fea_L3_conv2(lrelu(self.fea_L3_conv1(l2))))
        B = f1.shape[0]
        fea1 = [x[:B], l2[:B], l3[:B]]
        fea2 = [x[B:], l2[B:], l3[B:]]
        return self.fusion(self.pcd_align(fea1, fea2))
