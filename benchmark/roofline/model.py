"""A forward's work, counted from the shapes the inputs
need (the unpadded frames), as ``torch.utils.flop_counter.FlopCounterMode``
counts the plain reference (``benchmark/reference``): 2 FLOPs per
multiply-add of every conv (bias not counted), of each DCN's contraction,
of the SIREN nets' layers and of the MATLAB-bicubic skip resize's two
matrix products. Gathers, the DCN's sampling, bilinear resizes and
elementwise work are not counted. Also the list of DCN calls of a forward
(``benchmark/roofline/dcn.py`` reads it).

This starts from ``stif_tpu_torch/runtime/bench.py``'s ``flop_parts``,
extended to TMNet and to the train step, which counts three forwards.

An entry describes each unit of work it drives (a window, a train step) by
its shapes alone, a plain dict: ``{'model': 'stif', 'arch', 'batch', 'lr',
'nt', 'out'}`` or ``{'model': 'tmnet', 'arch', 'batch', 'frames', 'lr',
't_n'}``, with ``'train': True`` on a train step. ``count`` and ``flops``
read such a unit, and so do the work functions of ``siren.py`` and
``dcn.py``: a per-layer metric's reader finds its work from the units a
run recorded, whatever entry drove them.
"""

from __future__ import annotations

from typing import List, Tuple

from benchmark.roofline import siren

K3 = 9


def _down(hw):
    """A 3x3 stride-2 conv's output size (padding 1)."""
    return ((hw[0] - 1) // 2 + 1, (hw[1] - 1) // 2 + 1)


class Count:
    """FLOPs by kind and the DCN calls of one forward."""

    def __init__(self, nf: int, groups: int):
        self.nf, self.G = nf, groups
        self.parts = {"convs": 0, "dcn": 0, "resize": 0, "siren": 0}
        self.dcn_calls: List[Tuple[int, ...]] = []

    def conv(self, n, hw, cin, cout, k=K3):
        self.parts["convs"] += 2 * n * hw[0] * hw[1] * cin * cout * k

    def dcn(self, n, hw):
        nf = self.nf
        self.conv(n, hw, nf, 3 * self.G * K3)  # the offset-and-mask conv
        self.parts["dcn"] += 2 * n * hw[0] * hw[1] * K3 * nf * nf
        self.dcn_calls.append((n, hw[0], hw[1], nf, hw[0], hw[1], nf, K3,
                               self.G))

    def trunk(self, n, hw, blocks):
        for _ in range(2 * blocks):
            self.conv(n, hw, self.nf, self.nf)

    def pyramid(self, n, l1):
        nf = self.nf
        l2 = _down(l1)
        l3 = _down(l2)
        for hw in (l2, l2, l3, l3):
            self.conv(n, hw, nf, nf)
        return l2, l3

    def pcd(self, n, levels, tmb: bool = False):
        """A PCD alignment of ``n`` pairs, both directions; with ``tmb``
        each level's time modulation (three 1x1 convs of the time, two 3x3
        of the features)."""
        nf = self.nf
        l1, l2, l3 = levels
        for _ in range(2):
            self.conv(n, l3, 2 * nf, nf)
            self.conv(n, l3, nf, nf)
            self.dcn(n, l3)
            for hw in (l2, l1):
                self.conv(n, hw, 2 * nf, nf)
                self.conv(n, hw, 2 * nf, nf)
                self.conv(n, hw, nf, nf)
                self.dcn(n, hw)
                self.conv(n, hw, 2 * nf, nf)
            if tmb:
                for hw in (l1, l2, l3):
                    self.conv(n, (1, 1), 1, nf, 1)
                    self.conv(n, (1, 1), nf, nf, 1)
                    self.conv(n, (1, 1), nf, nf, 1)
                    self.conv(n, hw, nf, nf)
                    self.conv(n, hw, nf, nf)

    def convlstm(self, B, T, l1):
        nf = self.nf
        for _ in range(T):  # both directions: batch 2B
            for _ in range(2):  # pcd_h, pcd_c
                levels = (l1,) + self.pyramid(4 * B, l1)
                self.pcd(2 * B, levels)
                self.conv(2 * B, l1, 2 * nf, nf, 1)
            self.conv(2 * B, l1, 2 * nf, 4 * nf)
        self.conv(B * T, l1, 2 * nf, nf, 1)

    def front(self, n, l1, front_rbs):
        self.conv(n, l1, 3, self.nf)
        self.trunk(n, l1, front_rbs)
        return (l1,) + self.pyramid(n, l1)

    @property
    def flops(self) -> int:
        return sum(self.parts.values())


def stif(arch: dict, B: int, lr_hw, nt: int, out_hw) -> Count:
    """``LunaTokis`` on ``B`` pairs at LR ``lr_hw``, decoded at ``nt``
    times onto ``out_hw``."""
    c = Count(arch["nf"], arch["groups"])
    nf = arch["nf"]
    levels = c.front(2 * B, tuple(lr_hw), arch["front_RBs"])
    c.pcd(B, levels)
    c.conv(B, levels[0], 2 * nf, nf, 1)
    c.convlstm(B, 3, levels[0])
    c.trunk(3 * B, levels[0], arch["back_RBs"])
    H, W = lr_hw
    HH, WW = out_hw
    c.parts["resize"] += 2 * HH * H * B * W * 6 + 2 * WW * W * B * HH * 6
    c.parts["siren"] += sum(
        2 * nt * B * HH * WW * siren._weights(d)
        for d in siren.widths(nf).values())
    return c


def tmnet(arch: dict, B: int, N: int, lr_hw, t_n: int) -> Count:
    """TMNet on ``B`` windows of ``N`` LR frames at ``lr_hw`` with ``t_n``
    query times between each pair: T = N + (N - 1) t_n frames at x4."""
    c = Count(arch["nf"], arch["groups"])
    nf = arch["nf"]
    T = N + (N - 1) * t_n
    levels = c.front(N * B, tuple(lr_hw), arch["front_RBs"])
    l1 = levels[0]
    for _ in range((N - 1) * t_n):
        c.pcd(B, levels, tmb=True)
        c.conv(B, l1, 2 * nf, nf, 1)
    for _ in range(T):
        for _ in range(2):  # AtB, CtB
            c.conv(B, l1, 2 * nf, nf)
            c.conv(B, l1, nf, nf)
            c.dcn(B, l1)
        for _ in range(3):
            c.conv(B, l1, 3 * nf, 3 * nf, 1)
        c.conv(B, l1, 3 * nf, nf, 1)
    c.convlstm(B, T, l1)
    c.trunk(B * T, l1, arch["back_RBs"])
    H, W = lr_hw
    c.conv(B * T, (H, W), nf, 4 * nf)
    c.conv(B * T, (2 * H, 2 * W), nf, 256)
    c.conv(B * T, (4 * H, 4 * W), 64, 64)
    c.conv(B * T, (4 * H, 4 * W), 64, 3)
    return c


def count(unit: dict) -> Count:
    """The forward's count of one unit of work (see the module
    docstring)."""
    arch = unit["arch"]
    if unit["model"] == "stif":
        return stif(arch, unit["batch"], tuple(unit["lr"]), unit["nt"],
                    tuple(unit["out"]))
    if unit["model"] == "tmnet":
        return tmnet(arch, unit["batch"], unit["frames"], tuple(unit["lr"]),
                     unit["t_n"])
    raise KeyError(f"no work function for model {unit['model']!r}")


def flops(unit: dict) -> int:
    """A unit's FLOPs: its forward's, three times for a train step (the
    backward's data and weight products; the ConvLSTM's recompute not
    counted)."""
    return (3 if unit.get("train") else 1) * count(unit).flops
