"""The chips' published peaks, keyed by the name ``torch.cuda
.get_device_name`` gives: dense TF32 on the tensor cores (the fastest rate
at which fp32-accurate work can run there) and HBM bandwidth (NVIDIA H100
SXM data sheet, at its 700 W limit)."""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops": 495e12, "bytes": 3.35e12},
}


def peak(card: str) -> dict:
    """The peaks of ``card``; ``KeyError`` for a card the table lacks."""
    if card not in PEAKS:
        raise KeyError(f"no peaks are known for {card!r}; known cards: "
                       f"{', '.join(PEAKS)}")
    return PEAKS[card]


def bound_s(flops: float, nbytes: float, card: str) -> float:
    """The least time the card could take: the larger of the matrix
    FLOPs at the TF32 peak and the bytes at the HBM bandwidth."""
    p = peak(card)
    return max(flops / p["flops"], nbytes / p["bytes"])
