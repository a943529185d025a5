"""The work of STIF's arbitrary-scale architecture (``LIIF_train``, the
``LunaTokis`` train variant; ``reference/liif_train.py``) in one unit, as
the inputs need it, counted as ``model.py`` counts the flagship: the
encoder by ``model.py``'s ``Count`` (the same encoder), the three SIREN
nets at 2 FLOPs per multiply-add, and no bicubic skip.

A unit is ``{'model': 'liif_train', 'arch', 'batch', 'lr', 'nt', 'out'}``,
``out`` the unpadded frame. ``feat_imnet`` is counted once per query (stage
A has no time code: the function needs its field once, whatever the
program repeats), the other two once per query and time. Bytes, fp32: each
net's operands read once and its result written once, a field shared by
every query time counted once (stage A's inputs), the weights and biases.
"""

from __future__ import annotations

from benchmark.roofline import model

F32 = 4


def widths(nf: int) -> dict:
    """(in, hidden..., out) of each net for an input pair."""
    base = 3 * nf + 8  # the LR cell's features, the inputs, rel coords
    return {"feat_imnet": [base, 64, 64, 64, 256, 128],
            "flow_imnet": [128 + base + 1, 64, 64, 64, 256, 4],
            "encode_imnet": [2 * (128 + base - 2), 64, 64, 64, 256, 256, 27]}


def _macs(dims) -> int:
    return sum(a * b for a, b in zip(dims, dims[1:]))


def _rows(unit: dict):
    """(B * Q, nt * B * Q) of a unit: the queries, and with each time."""
    q = unit["batch"] * unit["out"][0] * unit["out"][1]
    return q, unit["nt"] * q


def work_of(unit: dict) -> dict:
    """{'flops', 'bytes'} of the three nets in one unit."""
    if unit["model"] != "liif_train":
        return {"flops": 0, "bytes": 0}
    w = widths(unit["arch"]["nf"])
    q, rows = _rows(unit)
    base = w["feat_imnet"][0]
    flops = 2 * (q * _macs(w["feat_imnet"])
                 + rows * (_macs(w["flow_imnet"]) + _macs(w["encode_imnet"])))
    params = sum(_macs(d) + sum(d[1:]) for d in w.values())
    t = unit["nt"] * unit["batch"]  # one time scalar per time and pair
    fields = (q * base                        # feat: stage A's inputs
              + rows * 128 + q * base + t     # flow: the HR field, A's, t
              + rows * w["encode_imnet"][0])  # encode: the four gathers
    outs = q * 128 + rows * (4 + 27)
    return {"flops": flops, "bytes": F32 * (fields + outs + params)}


def count(unit: dict) -> model.Count:
    """The forward's count: the flagship's encoder and the three nets."""
    arch = unit["arch"]
    B, nf = unit["batch"], arch["nf"]
    c = model.Count(nf, arch["groups"])
    levels = c.front(2 * B, tuple(unit["lr"]), arch["front_RBs"])
    c.pcd(B, levels)
    c.conv(B, levels[0], 2 * nf, nf, 1)
    c.convlstm(B, 3, levels[0])
    c.trunk(3 * B, levels[0], arch["back_RBs"])
    c.parts["siren"] += work_of(unit)["flops"]
    return c


def flops(unit: dict) -> int:
    return count(unit).flops
