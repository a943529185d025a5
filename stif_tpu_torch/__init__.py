"""stif_tpu_torch — PyTorch/CUDA port of stif_tpu for NVIDIA Hopper.

The JAX package ``stif_tpu`` is the reference; this package mirrors its
layout (``ops/``, ``nn/``, ``models/``, ``convert/``, ``runtime/``) and keeps
its public tensor layouts (channels-last images, ``(nt, B, HH, WW, 3)``
model output), so each function can be held against its counterpart.
Plain tensor code is PyTorch; the one TPU kernel of the serving path, the
fused SIREN MLP, is a hand-written CUDA kernel (``csrc/siren_fused.cu``).

This package imports ``torch``, ``numpy`` and the standard library only.
"""
