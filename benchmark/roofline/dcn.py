"""The work of DCNv2 calls, forward and backward, as the inputs need it.

A call is (B, H, W, Cin, Ho, Wo, Cout, K, G): a modulated deformable conv
of a (B, H, W, Cin) map to (B, Ho, Wo, Cout) with K taps and G offset
groups. Matrix FLOPs: the contraction of the sampled columns with the
weight, 2 B Ho Wo K Cin Cout forward; the backward's grad-columns
(grad_out times the weight) and weight gradient (columns times grad_out),
twice that. The bilinear sampling is not a matrix product and is not
counted. Bytes: each operand read once and each result written once, fp32:
forward x, the offsets (2 per tap and group) and mask, the weight and bias,
the output; backward grad_out, x, offsets, mask and weight read, grad x,
grad offsets, grad mask and grad weight written."""

from __future__ import annotations

from benchmark.roofline import model

F32 = 4


def _sizes(call):
    B, H, W, Cin, Ho, Wo, Cout, K, G = call
    return (B * H * W * Cin, B * Ho * Wo * G * K * 3, Cout * Cin * K,
            B * Ho * Wo * Cout, 2 * B * Ho * Wo * K * Cin * Cout)


def forward(calls) -> dict:
    flops = nbytes = 0
    for call in calls:
        x, om, w, out, f = _sizes(call)
        flops += f
        nbytes += F32 * (x + om + w + call[6] + out)
    return {"flops": flops, "bytes": nbytes}


def backward(calls) -> dict:
    flops = nbytes = 0
    for call in calls:
        x, om, w, out, f = _sizes(call)
        flops += 2 * f
        nbytes += F32 * (out + x + om + w + x + om + w)
    return {"flops": flops, "bytes": nbytes}


def forward_of(unit: dict) -> dict:
    """Every DCN forward's work in one unit (``model.py``'s units): the
    calls its forward needs, once each (a train step's recompute of the
    ConvLSTM's is not counted)."""
    return forward(model.count(unit).dcn_calls)


def backward_of(unit: dict) -> dict:
    """Every DCN backward's work in one unit: a train step's calls, none in
    a forward alone."""
    if not unit.get("train"):
        return {"flops": 0, "bytes": 0}
    return backward(model.count(unit).dcn_calls)
