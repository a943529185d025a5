"""Network factory (port of ``stif_tpu/models/factory.py`` ``define_g``).

``which_model_G`` names follow the reference: ``LIIF`` is the flagship
``LunaTokis`` and ``LunaTokis`` the fixed-x4 original. The ``lstm_fuse_dirs``
key, a way to run the same math on a TPU, is not read here.
"""

from __future__ import annotations

import torch

_DTYPES = {
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "fp8": torch.float8_e4m3fn, "float8_e4m3fn": torch.float8_e4m3fn,
}


def define_g(opt: dict):
    from stif_tpu_torch.models import LunaTokis, TMNet
    from stif_tpu_torch.models.ablations import _PRESETS, make_ablation
    from stif_tpu_torch.models.luna_tokis_variants import (
        LunaTokisNoFlow,
        LunaTokisS,
        LunaTokisTrain,
        LunaTokisZSM,
    )

    net = opt["network_G"]
    which = net["which_model_G"]
    kwargs = dict(
        nf=net.get("nf", 64), nframes=net.get("nframes", 6),
        groups=net.get("groups", 8), front_RBs=net.get("front_RBs", 5),
        back_RBs=net.get("back_RBs", 40),
    )
    if which == "LIIF":
        for key in ("gather_dtype", "mlp_dtype"):
            if net.get(key) in ("bf16", "bfloat16"):
                kwargs[key] = torch.bfloat16
        if net.get("rgb_skip"):
            kwargs["rgb_skip"] = True
            # rgb_skip: bicubic -> the skip term is gathered from a bicubic
            # pre-upsample (LunaTokis.rgb_skip_bicubic)
            if str(net.get("rgb_skip")).lower() == "bicubic":
                kwargs["rgb_skip_bicubic"] = True
        for key in ("encode_splitk", "stagec_dedup", "stagec_nearest"):
            if net.get(key):
                kwargs[key] = True
        if kwargs.get("encode_splitk"):
            kwargs["fused"] = False  # the fused kernel has no split-K form
        if net.get("stagec_dtype"):
            kwargs["stagec_dtype"] = _DTYPES[str(net.get("stagec_dtype"))]
        return LunaTokis(**kwargs)
    plain = {"LIIF_train": LunaTokisTrain, "LIIF_noflow": LunaTokisNoFlow,
             "LIIF_S": LunaTokisS, "LunaTokis": LunaTokisZSM, "TMNet": TMNet}
    if which in plain:
        return plain[which](**kwargs)
    if which.startswith("LIIF_") and which[len("LIIF_"):] in _PRESETS:
        return make_ablation(which[len("LIIF_"):], **kwargs)
    raise NotImplementedError(f"Generator model [{which}] not recognized")
