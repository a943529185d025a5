#!/usr/bin/env python
"""Training script of the PyTorch/CUDA port (counterpart of
``scripts/train.py``).

Usage:
  python scripts/train_torch.py -opt configs/train_synthetic_r5.yml \
      [--steps N] [--resume] [--device cuda|cpu]
  python -m torch.distributed.run --nproc_per_node N \
      scripts/train_torch.py --parallel -opt CONFIG.yml [...]

Reads the reference-schema YAML, builds the dataset, the loader and
``VideoSRModel``, and runs the train loop: parameters drawn from the first
batch's model by the reference's init, the warm start / resume rules,
checkpoints every ``logger.save_checkpoint_freq`` steps, a log line every
``logger.print_freq`` steps, and, when ``train.val_freq`` is set, an
in-process Vid4-protocol probe on a held-out dev split every ``val_freq``
steps with keep-best weights (``params_best_<step>.pth`` and
``val_curve.jsonl`` beside the checkpoints). Keep-best is seeded with a
probe of the starting weights; the EMA weights are probed beside the raw
ones and the better of the two is kept. Runs on a CUDA GPU and raises
where there is none unless ``--device cpu`` is given. ``run`` is the body,
callable with an options dict.

``--parallel`` trains data-parallel, one process per device, under
``torch.distributed.run`` (it reads ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``; NCCL between cards, gloo with ``--device cpu``): each
rank's loader takes every ``world``-th index of the sampler and
``batch_size / world`` samples per batch, so that the ranks' shares make
up the global batch of world size 1. Rank 0 writes ``train.log``, the
tensorboard events, the checkpoints and runs the validation probes.
"""

import argparse
import itertools
import logging
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def run(opt: dict, steps=None, resume: bool = False, device=None,
        parallel: bool = False) -> int:
    """Train by the options dict ``opt`` (the schema of the YAML configs)
    up to ``steps`` (default ``train.niter``); ``resume`` continues from the
    latest checkpoint in ``path.models``; ``parallel`` trains
    data-parallel over the process group (see the module's docstring).
    Returns the last step."""
    from stif_tpu_torch.data.datasets import create_train_dataset
    from stif_tpu_torch.data.loader import DataLoader, ShardedIterSampler
    from stif_tpu_torch.parallel.distributed import barrier
    from stif_tpu_torch.train.video_sr_model import VideoSRModel

    # raises first without a GPU
    model = VideoSRModel(opt, device=device, parallel=parallel)
    main_rank = model.rank == 0
    sync = barrier if parallel else (lambda: None)
    log = logging.getLogger("base")
    models_dir = (opt.get("path") or {}).get("models")
    handler = None
    if models_dir and main_rank:
        os.makedirs(models_dir, exist_ok=True)
        handler = logging.FileHandler(os.path.join(models_dir, "train.log"))
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(message)s"))
        log.addHandler(handler)
        log.setLevel(logging.INFO)
    niter = int(steps or opt["train"]["niter"])

    tb = None
    if opt.get("use_tb_logger") and models_dir and main_rank:
        from stif_tpu_torch.utils.tb import TBWriter

        tb = TBWriter(os.path.join(models_dir, "tb"))
        log.info("tensorboard events -> %s", tb.path)

    dopt = opt["datasets"]["train"]
    ds, collate = create_train_dataset(opt)
    batch_size = int(dopt.get("batch_size", 18))
    if batch_size % model.world:
        raise ValueError(f"batch_size {batch_size} does not divide over "
                         f"{model.world} ranks")
    loader = DataLoader(ds, batch_size=batch_size // model.world,
                        collate=collate,
                        sampler=ShardedIterSampler(
                            len(ds), ratio=100, world_size=model.world,
                            rank=model.rank))
    # init from the first batch; it is trained on too (chained back in
    # front of its epoch)
    gen = loader.epoch(0)
    try:
        first = next(gen)
        it = itertools.chain([first], gen)
        model.init_params(first["LQs"], first["times"])
        start = 0
        pretrain = (opt.get("path") or {}).get("pretrain_model_G")
        if resume:
            try:
                start = model.resume_training()
                log.info("resumed at step %d", start)
            except FileNotFoundError:
                # a restart before the first checkpoint: fall back to the warm
                # start weights instead of failing
                if pretrain:
                    model.load_pth(pretrain)
                    log.info("no checkpoint yet; loaded pretrain %s", pretrain)
        elif pretrain:
            # warm start from reference-schema weights: params only, fresh
            # optimizer moments
            model.load_pth(pretrain)
            log.info("loaded pretrain weights from %s", pretrain)

        logger_opt = opt.get("logger") or {}
        ckpt_freq = int(float(logger_opt.get("save_checkpoint_freq", 1000)))
        print_freq = int(logger_opt.get("print_freq", 100))

        val_freq = int(float((opt.get("train") or {}).get("val_freq", 0) or 0))
        validator = best = None
        if val_freq and models_dir and main_rank:
            from stif_tpu_torch.train.validation import BestTracker, Validator

            vopt = (opt.get("datasets") or {}).get("val") or {}
            validator = Validator(model.net,
                                  root=vopt.get("root", "runs/val_data"),
                                  n_scenes=int(vopt.get("n_scenes", 3)),
                                  device=model.device,
                                  scale_probes=vopt.get("scale_probes") or ())
            best = BestTracker(models_dir)
            log.info("validation every %d steps on %s (keep-best on t0+t0.5 "
                     "Y-PSNR)", val_freq, validator.root)

        def run_validation(step):
            vt = time.time()
            params = model.net.state_dict()
            m = validator.validate(params)
            m["is_ema"] = 0.0
            cand, cand_params = m, params
            ema_note = ""
            if model.ema_params is not None:
                me = validator.validate(model.ema_params)
                me["is_ema"] = 1.0
                ema_note = " ema %.3f" % me["score"]
                if me["score"] > m["score"]:
                    cand, cand_params = me, model.ema_params
            is_best = best.update(step, cand, cand_params)
            log.info(
                "val @ %d: t0 %.3f t0.5 %.3f (score %.3f%s, %.0f s)%s", step,
                m["t0_psnr"], m["t05_psnr"], m["score"], ema_note,
                time.time() - vt,
                " ** new best **" + (" (ema)" if cand is not m else "")
                if is_best else "")
            if tb:
                tb.add_scalar("val/t0_psnr", m["t0_psnr"], step)
                tb.add_scalar("val/t05_psnr", m["t05_psnr"], step)
                tb.add_scalar("val/score", m["score"], step)
                if model.ema_params is not None:
                    tb.add_scalar("val/ema_score", me["score"], step)
                tb.flush()

        # keep-best is a floor: seed it with the starting weights, so a
        # warm-started run never selects a probe worse than its start
        if validator and best.best is None:
            run_validation(start)
        sync()

        step, epoch, t0 = start, 0, time.time()
        while step < niter:
            for batch in it:
                # times pass through at full (B, nt): per-sample pe
                model.feed_data({"LQs": batch["LQs"], "GT": batch["GT"],
                                 "times": np.asarray(batch["times"])})
                logs = model.optimize_parameters()
                step += 1
                if step % print_freq == 0:
                    rate = print_freq / (time.time() - t0)
                    t0 = time.time()
                    log.info("step %d loss %.4f gnorm %.3f (%.2f it/s)",
                             step, logs["loss"], logs["grad_norm"], rate)
                    if tb:
                        tb.add_scalar("train/loss", logs["loss"], step)
                        tb.add_scalar("train/grad_norm", logs["grad_norm"],
                                      step)
                        tb.flush()
                if ckpt_freq and step % ckpt_freq == 0 and model.ckpt:
                    model.save()
                    log.info("checkpoint @ %d", step)
                if val_freq and step % val_freq == 0:
                    if validator:
                        run_validation(step)
                    sync()
                    t0 = time.time()  # val time is not counted in it/s
                if step >= niter:
                    break
            epoch += 1
            gen.close()
            it = gen = loader.epoch(epoch)

        if model.ckpt:
            model.save()
        if validator and step % val_freq != 0:
            run_validation(step)
        sync()
        log.info("done at step %d", step)
        return step
    finally:
        gen.close()  # stops the loader's thread
        if tb:
            tb.close()
        if handler:
            log.removeHandler(handler)
            handler.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-opt", required=True, help="path to YAML option file")
    ap.add_argument("--steps", type=int, default=None,
                    help="override train.niter")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--parallel", action="store_true",
                    help="data parallel, one process per device, under "
                         "python -m torch.distributed.run")
    args = ap.parse_args(argv)

    from stif_tpu_torch.utils.config import parse_options

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    opt = parse_options(args.opt, is_train=True)
    try:
        return run(opt, steps=args.steps, resume=args.resume,
                   device=args.device, parallel=args.parallel)
    finally:
        if args.parallel:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()


if __name__ == "__main__":
    main()
