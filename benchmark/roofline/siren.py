"""The work of STIF's three SIREN nets in one decode, as the inputs need
it: 2 FLOPs per multiply-add of each layer's matrix product (sines and
biases not counted), and the bytes of each net's operands read once and its
result written once, a field shared by every query time counted once.

``Q`` is the output pixels the window needs (the unpadded frame), ``nt``
the query times, ``B`` the pairs; fp32 (4 bytes)."""

from __future__ import annotations

F32 = 4


def widths(nf: int) -> dict:
    """(in, hidden..., out) of each net for an input pair."""
    return {"feat_imnet": [3 * nf + 9, 64, 64, 256, 64],
            "flow_imnet": [3 * nf + 71, 64, 64, 256, 4],
            "encode_imnet": [6 * nf + 141, 64, 64, 256, 256, 3]}


def _weights(dims) -> int:
    return sum(a * b for a, b in zip(dims, dims[1:]))


def work(nf: int, B: int, nt: int, Q: int) -> dict:
    """{'flops', 'bytes'} of the three nets over one decode."""
    w = widths(nf)
    rows = nt * B * Q
    flops = sum(2 * rows * _weights(d) for d in w.values())
    params = sum(_weights(d) + sum(d[1:]) for d in w.values())
    t = nt * B  # each net's query time, one scalar per time and pair
    fields = (
        B * Q * (3 * nf + 8) + t                # feat: LR cell, inputs, rel
        + rows * 64 + B * Q * (3 * nf + 6) + t  # flow: HR feature, bilinear
        + rows * (2 * 64 + 2 * 3 * nf + 12) + t)  # encode: gathers, images
    outs = rows * (64 + 4 + 3)
    return {"flops": flops, "bytes": F32 * (fields + outs + params)}


def work_of(unit: dict) -> dict:
    """The three nets' work in one unit (``model.py``'s units): a STIF
    unit's decode at its output size, none in any other model."""
    if unit["model"] != "stif":
        return {"flops": 0, "bytes": 0}
    hw = unit["out"][0] * unit["out"][1]
    return work(unit["arch"]["nf"], unit["batch"], unit["nt"], hw)
