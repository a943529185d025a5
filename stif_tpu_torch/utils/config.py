"""YAML config system (port of ``stif_tpu/utils/config.py``): ordered-YAML
parse, recursive ``NoneDict`` (missing keys read as ``None``), experiment
and results path derivation, per-dataset scale propagation, and the
``check_resume`` rewiring. ``yaml`` is imported when a file is parsed, so
the package imports without it; a ``.json`` options file (the same schema)
is read without ``yaml``."""

from __future__ import annotations

import os


class NoneDict(dict):
    """dict whose missing keys read as None."""

    def __missing__(self, key):
        return None


def dict_to_nonedict(opt):
    if isinstance(opt, dict):
        return NoneDict({k: dict_to_nonedict(v) for k, v in opt.items()})
    if isinstance(opt, list):
        return [dict_to_nonedict(v) for v in opt]
    return opt


def parse_options(path: str, is_train: bool = True) -> NoneDict:
    with open(path) as f:
        if path.endswith(".json"):
            import json

            opt = json.load(f)
        else:
            import yaml

            opt = yaml.safe_load(f)

    opt["is_train"] = is_train
    scale = opt.get("scale")

    for phase, dataset in (opt.get("datasets") or {}).items():
        phase = phase.split("_")[0]
        dataset["phase"] = phase
        if scale is not None:
            dataset["scale"] = scale

    path_cfg = opt.setdefault("path", {})
    path_cfg.setdefault("root", os.getcwd())
    if is_train:
        exp_root = os.path.join(path_cfg["root"], "experiments",
                                opt.get("name", "exp"))
        path_cfg.setdefault("experiments_root", exp_root)
        path_cfg.setdefault("models", os.path.join(exp_root, "models"))
        path_cfg.setdefault("training_state", os.path.join(exp_root,
                                                           "training_state"))
        path_cfg.setdefault("log", exp_root)
        path_cfg.setdefault("val_images", os.path.join(exp_root, "val_images"))
        if "debug" in opt.get("name", ""):
            tr = opt.setdefault("train", {})
            tr["val_freq"] = 8
            opt.setdefault("logger", {})["print_freq"] = 1
            opt["logger"]["save_checkpoint_freq"] = 8
    else:
        res_root = os.path.join(path_cfg["root"], "results",
                                opt.get("name", "exp"))
        path_cfg.setdefault("results_root", res_root)
        path_cfg.setdefault("log", res_root)

    return dict_to_nonedict(opt)


def check_resume(opt: NoneDict, resume_iter: int):
    """Point ``pretrain_model_G`` at the checkpoint for ``resume_iter``."""
    if opt["path"].get("resume_state"):
        opt["path"]["pretrain_model_G"] = os.path.join(
            opt["path"]["models"], f"params_{resume_iter}"
        )
    return opt
