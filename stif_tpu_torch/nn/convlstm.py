"""ConvLSTM cell and the bidirectional deformable ConvLSTM (port of
``stif_tpu/nn/convlstm.py``): before each cell step the hidden and cell
states are PCD-aligned to the current input."""

from __future__ import annotations

import torch
import torch.nn as nn

from stif_tpu_torch.nn.blocks import Conv, remat
from stif_tpu_torch.nn.pcd import EasyPCD


class ConvLSTMCell(nn.Module):
    def __init__(self, hidden_dim: int = 64, kernel_size: int = 3):
        super().__init__()
        self.conv = Conv(2 * hidden_dim, 4 * hidden_dim, kernel_size, 1,
                         kernel_size // 2)

    def forward(self, x: torch.Tensor, state):
        h, c = state
        gates = self.conv(torch.cat([x, h], -1))
        cc_i, cc_f, cc_o, cc_g = torch.chunk(gates, 4, dim=-1)
        c_next = torch.sigmoid(cc_f) * c + torch.sigmoid(cc_i) * torch.tanh(cc_g)
        h_next = torch.sigmoid(cc_o) * torch.tanh(c_next)
        return h_next, c_next


class DeformableConvLSTM(nn.Module):
    """Unidirectional deformable ConvLSTM over (B, T, H, W, C); state starts
    at zero."""

    def __init__(self, nf: int = 64, groups: int = 8, gather_dtype=None):
        super().__init__()
        self.nf = nf
        self.pcd_h = EasyPCD(nf, groups, gather_dtype)
        self.pcd_c = EasyPCD(nf, groups, gather_dtype)
        self.cell_list = nn.ModuleList([ConvLSTMCell(nf)])

    def _step(self, x_t: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        return self.cell_list[0](x_t, (self.pcd_h(x_t, h), self.pcd_c(x_t, c)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, H, W, _ = x.shape
        h = x.new_zeros(B, H, W, self.nf)
        c = x.new_zeros(B, H, W, self.nf)
        hs = []
        for t in range(T):
            # with grad on, each step's two PCD pyramids are recomputed in
            # the backward pass (the JAX package's ``nn.remat`` step)
            h, c = remat(self._step, x[:, t], h, c)
            hs.append(h)
        return torch.stack(hs, 1)


class BiDeformableConvLSTM(nn.Module):
    """Forward and reversed passes through the same network, channel concat,
    1x1 merge. Both directions run as one pass at batch 2B, [x; reversed x]:
    every op of a step is per-sample, so this is the same maths."""

    def __init__(self, nf: int = 64, groups: int = 8, gather_dtype=None):
        super().__init__()
        self.nf = nf
        self.forward_net = DeformableConvLSTM(nf, groups, gather_dtype)
        self.conv_1x1 = Conv(2 * nf, nf, 1, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        both = self.forward_net(torch.cat([x, x.flip(1)], 0))
        out_fwd, out_rev = both[:B], both[B:].flip(1)
        _, T, H, W, C = out_fwd.shape
        merged = torch.cat([out_fwd, out_rev], -1).reshape(B * T, H, W, 2 * C)
        return self.conv_1x1(merged).reshape(B, T, H, W, self.nf)
