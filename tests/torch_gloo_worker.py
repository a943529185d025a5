"""One rank of the port's data- and tensor-parallel checks, run by
``tests/test_torch_parallel.py`` in processes it spawns (gloo on the CPU,
world size 2). It imports no JAX: each rank writes what it saw to
``<out_dir>/rank<r>.pt``, and the test compares.

In order, on every rank:

1. ``scripts/train_torch.py``'s ``run(parallel=True)`` for 3 steps on a
   tiny synthetic config (checkpoint at 2 and at the end); the rank joins
   the process group from ``torch.distributed.run``'s environment
   variables, which the test sets;
2. the data-parallel train step, each rank on its half of one global
   batch, two steps, with the sum-reduced 'cb' and the mean-reduced 'l1'
   criteria; rank 0 also takes the same two steps in one process on the
   whole batch;
3. tensor parallelism over a (data 1, model 2) mesh: the model's output
   with its decoder layers sharded, the kernel's refusal of a DTensor, and
   the sharded SIREN's refusal of ``compute_dtype`` and ``split_first``;
4. ``shard_queries`` there and back.
"""

from __future__ import annotations

import importlib.util
import os
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
NET = dict(which_model_G="LIIF", nf=8, nframes=6, groups=2, front_RBs=1,
           back_RBs=1, rgb_skip="bicubic")
TRAIN = dict(lr_G=1e-3, warmup_iter=-1, T_period=[100], restarts=[],
             restart_weights=[], eta_min=1e-7, grad_clip=1e6)


def run_opt(models_dir: str) -> dict:
    """A tiny synthetic training config: B 4, nt 2, two scale buckets."""
    return {
        "model": "VideoSR_base", "scale": 4,
        "datasets": {"train": {
            "mode": "Synthetic", "n_items": 40, "nt": 2, "seed": 3,
            "batch_size": 4, "GT_size": 32,
            "scale_plan": [[4, 8], [2, 12]]}},
        "network_G": dict(NET),
        "path": {"models": models_dir},
        "train": dict(TRAIN, ema_decay=0.9, niter=3),
        "logger": {"print_freq": 1, "save_checkpoint_freq": 2},
    }


def global_batch(B: int = 4) -> dict:
    rng = np.random.default_rng(0)
    return {"LQs": rng.random((B, 2, 8, 8, 3)).astype(np.float32),
            "GT": rng.random((B, 2, 32, 32, 3)).astype(np.float32),
            "times": rng.random((B, 2)).astype(np.float32)}


def load_script(name: str):
    path = ROOT / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _numpy_state(net) -> dict:
    return {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}


def ddp_steps(criterion: str, rank: int) -> dict:
    """Two data-parallel steps, each rank on its rows of the global batch;
    on rank 0 also two single-process steps on the whole batch from the
    same init."""
    from stif_tpu_torch.parallel import default_mesh
    from stif_tpu_torch.train.trainer import make_parallel_train_step
    from stif_tpu_torch.train.video_sr_model import VideoSRModel

    opt = {"model": "VideoSR_base", "network_G": dict(NET),
           "train": dict(TRAIN, pixel_criterion=criterion)}
    b = global_batch()
    world = torch.distributed.get_world_size()
    rows = slice(rank * 4 // world, (rank + 1) * 4 // world)
    tensors = {"lqs": torch.from_numpy(b["LQs"][rows]),
               "gt": torch.from_numpy(b["GT"][rows]),
               "times": torch.from_numpy(b["times"][rows])}
    m = VideoSRModel(opt, device="cpu")
    m.init_params(b["LQs"], b["times"], seed=0)
    mesh = default_mesh(world, device_type="cpu")
    step = make_parallel_train_step(m.net, m.optimizer, m.cfg, mesh,
                                    per_sample_times=True)
    logs = [{k: float(v) for k, v in step(tensors, i).items()}
            for i in range(2)]
    out = {"logs": logs, "params": _numpy_state(m.net),
           "state_keys": sorted(m.optimizer.state_dict()["state"])}
    if rank == 0:
        ref = VideoSRModel(opt, device="cpu")
        ref.init_params(b["LQs"], b["times"], seed=0)
        ref.feed_data(b)
        out["ref_logs"] = [ref.optimize_parameters() for _ in range(2)]
        out["ref_params"] = _numpy_state(ref.net)
        out["ref_state_keys"] = sorted(ref.optimizer.state_dict()["state"])
    return out


def tensor_parallel() -> dict:
    """The tiny model's output with its decoder layers sharded over the
    (data 1, model 2) mesh, against its own output before."""
    from torch.distributed.tensor import distribute_tensor, Shard

    from stif_tpu_torch.models.factory import define_g
    from stif_tpu_torch.nn.init import init_model_
    from stif_tpu_torch.nn.siren import Siren
    from stif_tpu_torch.ops import siren_apply_fused
    from stif_tpu_torch.parallel import (apply_tensor_parallel, device_mesh,
                                         make_mesh)

    torch.manual_seed(0)
    net = define_g({"network_G": dict(NET)}).eval()
    init_model_(net, torch.Generator().manual_seed(1))
    x = torch.from_numpy(global_batch(1)["LQs"])
    t = torch.tensor([0.0, 0.5])
    with torch.no_grad():
        want = net(x, t).numpy()
    mesh = make_mesh({"data": 1, "model": 2}, [torch.device("cpu")] * 2)
    layers = apply_tensor_parallel(net, mesh)
    sirens = [m for m in net.modules() if isinstance(m, Siren)]
    with torch.no_grad():
        got = net(x, t).numpy()
    w = net.feat_imnet.net[0].linear.weight
    refused = ""
    try:
        siren_apply_fused([torch.zeros(5, w.shape[1])], [w.t()],
                          [torch.zeros(w.shape[0])])
    except RuntimeError as e:
        refused = str(e)
    dm = device_mesh(mesh)["model"]
    bias = distribute_tensor(torch.zeros(8), dm, [Shard(0)])
    try:
        siren_apply_fused([torch.zeros(5, 4)], [torch.zeros(4, 8)], [bias])
        refused_bias = False
    except RuntimeError:
        refused_bias = True
    # the sharded layers run fp32 and whole: a reduced precision or a
    # split first layer would be reported and not computed
    net_siren = net.feat_imnet
    conflicts = []
    for knob, value in (("compute_dtype", torch.bfloat16),
                        ("split_first", True)):
        setattr(net_siren, knob, value)
        try:
            with torch.no_grad():
                net_siren(torch.zeros(5, w.shape[1]))
        except ValueError as e:
            conflicts.append(str(e))
        setattr(net_siren, knob, None if knob == "compute_dtype" else False)
    return {"want": want, "got": got, "layers": layers,
            "conflicts": conflicts,
            "local_rows": int(w.to_local().shape[0]),
            "fused": [m.fused for m in sirens], "refused": refused,
            "refused_bias": refused_bias}


def queries(rank: int) -> dict:
    from stif_tpu_torch.parallel import make_mesh, shard_queries

    mesh = make_mesh({"data": 1, "model": 2}, [torch.device("cpu")] * 2)
    x = torch.arange(2 * 6 * 3, dtype=torch.float32).reshape(2, 6, 3)
    d = shard_queries(x, mesh, axis=1)
    local = d.to_local()
    return {"local": local.numpy().copy(),
            "want_local": x[:, 3 * rank:3 * rank + 3].numpy().copy(),
            "full_equal": bool(torch.equal(d.full_tensor(), x))}


def main(rank: int, world: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    out = {}
    try:
        # 1: the script; its model joins the group from the environment
        train = load_script("train_torch")
        out["run_last"] = train.run(run_opt(os.path.join(out_dir, "par")),
                                    steps=3, device="cpu", parallel=True)
        out["group_from_env"] = dist.is_initialized()
        # 2, 3, 4
        out["cb"] = ddp_steps("cb", rank)
        out["l1"] = ddp_steps("l1", rank)
        out["tp"] = tensor_parallel()
        out["queries"] = queries(rank)
        dist.barrier()
    finally:
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        if dist.is_initialized():
            dist.destroy_process_group()
