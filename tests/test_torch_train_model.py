"""``VideoSRModel``, its checkpoints, keep-best and the training init, on the
CPU: the loss falls; save and resume reproduce params, optimizer state,
step and EMA bitwise and the run continues bitwise; ``BestTracker`` keeps a
floor; ``init_model_`` draws every parameter by the rule of its JAX
counterpart; no SIREN of a training model runs the fused kernel."""

import json
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stif_tpu.models import LunaTokis as JLunaTokis

from stif_tpu_torch.convert import jax_params_to_state_dict, load_pth
from stif_tpu_torch.models import LunaTokis
from stif_tpu_torch.nn import Siren
from stif_tpu_torch.nn.init import init_model_
from stif_tpu_torch.train.checkpoints import CheckpointManager
from stif_tpu_torch.train.validation import BestTracker, load_best_params
from stif_tpu_torch.train.video_sr_model import (VideoSRModel, create_model,
                                                 from_torch_batch)
import torch_parity  # noqa: F401  (caps PyTorch's threads)

NET = dict(which_model_G="LIIF", nf=8, nframes=6, groups=2, front_RBs=1,
           back_RBs=1, rgb_skip="bicubic")


def _opt(tmp_path, **train):
    tr = dict(lr_G=1e-3, warmup_iter=-1, T_period=[100], restarts=[],
              restart_weights=[], eta_min=1e-7, grad_clip=1e6,
              ema_decay=0.9)
    tr.update(train)
    return {"model": "VideoSR_base", "network_G": dict(NET),
            "path": {"models": str(tmp_path / "models")}, "train": tr}


def _batch(seed=0, B=2):
    rng = np.random.default_rng(seed)
    return {"LQs": rng.random((B, 2, 8, 8, 3)).astype(np.float32),
            "GT": rng.random((B, 2, 32, 32, 3)).astype(np.float32),
            "times": np.asarray([[0.0, 0.5], [1.0, 0.25]][:B], np.float32)}


def _model(tmp_path, seed=0, **train):
    m = VideoSRModel(_opt(tmp_path, **train), device="cpu")
    b = _batch()
    m.init_params(b["LQs"], b["times"], seed=seed)
    m.feed_data(b)
    return m


def _state(m):
    """Everything a resume must restore, as CPU copies."""
    opt = m.optimizer.state_dict()
    return {"step": m.step,
            "params": {k: v.clone() for k, v in m.net.state_dict().items()},
            "moments": {i: {k: v.clone() for k, v in s.items()}
                        for i, s in opt["state"].items()},
            "ema": {k: v.clone() for k, v in m.ema_params.items()}}


def _assert_bitwise(a, b):
    assert a["step"] == b["step"]
    for key in ("params", "ema"):
        assert a[key].keys() == b[key].keys()
        for k in a[key]:
            assert torch.equal(a[key][k], b[key][k]), (key, k)
    assert a["moments"].keys() == b["moments"].keys()
    for i in a["moments"]:
        for k, v in a["moments"][i].items():
            assert torch.equal(v, b["moments"][i][k]), ("moments", i, k)


def test_loss_falls(tmp_path):
    m = _model(tmp_path, lr_G=1e-4)
    losses = [m.optimize_parameters()["loss"] for _ in range(8)]
    assert m.step == 8 and m.get_current_log()["loss"] == losses[-1]
    assert losses[-1] < losses[0]
    assert np.isfinite(m.get_current_log()["grad_norm"])


def test_save_resume_bitwise(tmp_path):
    """Save at step 2, step on; a fresh model with other initial weights
    resumes bitwise (params, Adam moments, step, EMA) and its next step
    equals the uninterrupted one bitwise."""
    m = _model(tmp_path)
    for _ in range(2):
        m.optimize_parameters()
    assert m.save() == 2
    saved = _state(m)
    loss3 = m.optimize_parameters()["loss"]
    after = _state(m)

    r = _model(tmp_path, seed=7)
    assert not torch.equal(r.net.conv_first.weight, saved["params"][
        "conv_first.weight"])
    assert r.resume_training() == 2
    _assert_bitwise(_state(r), saved)
    assert r.optimize_parameters()["loss"] == loss3
    _assert_bitwise(_state(r), after)


def test_checkpoint_files(tmp_path):
    """max_to_keep, latest_step, restore by step, the EMA sibling kept two
    deep, a weights-only file that ``load_pth`` loads strictly, and
    ``FileNotFoundError`` for a missing checkpoint."""
    m = _model(tmp_path)
    m.ckpt.max_to_keep = 2
    for _ in range(3):
        m.optimize_parameters()
        m.save()
    names = sorted(os.listdir(m.ckpt.directory))
    assert names == ["checkpoint_2.pth", "checkpoint_3.pth",
                     "ema_params_2.pth", "ema_params_3.pth"]
    assert m.ckpt.latest_step() == 3
    assert m.ckpt.restore(2)["step"] == 2
    with pytest.raises(FileNotFoundError):
        m.ckpt.restore(1)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()
    path = m.save_network(3)
    net = LunaTokis(nf=8, groups=2, front_RBs=1, back_RBs=1)
    load_pth(net, path)  # strict
    assert torch.equal(net.conv_first.weight, m.net.conv_first.weight)
    m.ckpt.save_params_only(m.net.state_dict(), 4, keep=1)
    assert not os.path.exists(path)


def test_resume_without_ema_snapshot_and_warm_start(tmp_path):
    """A checkpoint written before EMA was on re-seeds EMA from the params;
    a warm start from a ``.pth`` (strict) re-seeds it too."""
    m = _model(tmp_path, ema_decay=0)
    m.optimize_parameters()
    m.save()
    r = _model(tmp_path, seed=3)
    assert r.resume_training() == 1
    for k, v in r.net.state_dict().items():
        assert torch.equal(r.ema_params[k], v)
    pth = m.save_network(1)
    w = _model(tmp_path, seed=4)
    w.load_pth(pth)
    for k, v in m.net.state_dict().items():
        assert torch.equal(w.net.state_dict()[k], v)
        assert torch.equal(w.ema_params[k], v)


def test_ema_follows_params(tmp_path):
    m = _model(tmp_path)
    e0 = {k: v.clone() for k, v in m.ema_params.items()}
    m.optimize_parameters()
    p = m.net.state_dict()
    for k in ("conv_first.weight", "encode_imnet.net.4.bias"):
        torch.testing.assert_close(m.ema_params[k],
                                   0.9 * e0[k] + 0.1 * p[k], rtol=0,
                                   atol=1e-7)


def test_no_siren_runs_the_kernel(tmp_path):
    """The training net's SIRENs are plain (the kernel has no backward);
    ``test`` turns the kernel on under ``inference_mode`` and off again."""
    for which in ("LIIF", "LIIF_train", "LIIF_S", "LIIF_noflow"):
        opt = _opt(tmp_path)
        opt["network_G"]["which_model_G"] = which
        m = create_model(opt, device="cpu")
        sirens = [s for s in m.net.modules() if isinstance(s, Siren)]
        assert sirens and not any(s.fused for s in sirens), which
    m = _model(tmp_path)
    seen = []
    hook = m.net.encode_imnet.register_forward_hook(
        lambda mod, a, out: seen.append((mod.fused, out.requires_grad)))
    out = m.test()
    hook.remove()
    assert seen == [(True, False)] and out.shape == (2, 2, 32, 32, 3)
    assert not any(s.fused for s in m.net.modules() if isinstance(s, Siren))
    with pytest.raises(NotImplementedError):
        create_model({"model": "SRGAN", "network_G": dict(NET)})
    # data parallel needs a process group (torch.distributed.run's
    # environment, or one made by the caller)
    with pytest.raises(RuntimeError, match="process group"):
        VideoSRModel(_opt(tmp_path), device="cpu", parallel=True)


def test_from_torch_batch():
    rng = np.random.default_rng(0)
    lqs = rng.random((2, 2, 3, 4, 5)).astype(np.float32)
    gt = rng.random((2, 3, 3, 8, 10)).astype(np.float32)
    time = [np.asarray([0.1, 0.2]), np.asarray([0.3, 0.4]),
            np.asarray([0.5, 0.6])]
    out = from_torch_batch({"LQs": lqs, "GT": gt, "time": time})
    assert out["LQs"].shape == (2, 2, 4, 5, 3)
    assert out["GT"].shape == (2, 3, 8, 10, 3)
    np.testing.assert_array_equal(out["times"], [[0.1, 0.3, 0.5],
                                                 [0.2, 0.4, 0.6]])


# --------------------------------------------------------------- keep-best

def _params(v):
    return {"w": torch.full((4,), float(v)), "b": torch.zeros(2)}


def _metrics(score):
    return {"t0_psnr": score / 2, "t05_psnr": score / 2, "t0_ssim": 0.9,
            "t05_ssim": 0.7, "mean_psnr": score / 2, "score": score}


def test_keep_best_floor_and_curve(tmp_path):
    d = str(tmp_path / "models")
    bt = BestTracker(d)
    assert bt.best is None
    assert bt.update(0, _metrics(61.28), _params(1.0))   # the seed probe
    assert not bt.update(250, _metrics(60.9), _params(2.0))  # worse
    assert bt.best["step"] == 0
    assert not bt.update(500, _metrics(61.28), _params(3.0))  # equal
    assert bt.update(750, _metrics(61.5), _params(4.0))
    assert bt.best["step"] == 750
    snaps = [n for n in os.listdir(d) if n.startswith("params_best_")]
    assert snaps == ["params_best_750.pth"]
    restored, best = load_best_params(d)
    assert best["step"] == 750 and best["score"] == 61.5
    assert torch.equal(restored["w"], torch.full((4,), 4.0))
    curve = [json.loads(line)
             for line in open(os.path.join(d, "val_curve.jsonl"))]
    assert [r["step"] for r in curve] == [0, 250, 500, 750]
    bt2 = BestTracker(d)  # resumes the floor from best.json
    assert bt2.best["score"] == 61.5
    assert not bt2.update(1000, _metrics(61.3), _params(5.0))


# -------------------------------------------------------------------- init

def _rule(name, shape):
    """(kind, scale) of the reference's training init for a parameter of
    ``LunaTokis``: ('u', bound), ('n', std) or ('0', 0)."""
    fan_in = math.prod(shape[1:]) if len(shape) > 1 else None
    if "conv_offset_mask" in name:
        return "0", 0.0
    if "dcnpack" in name:
        return ("0", 0.0) if name.endswith("bias") else (
            "u", 1 / math.sqrt(fan_in))
    if "feature_extraction" in name or "recon_trunk" in name:
        return ("0", 0.0) if name.endswith("bias") else (
            "n", 0.1 * math.sqrt(2 / fan_in))
    if "imnet" in name:
        return None  # needs the layer's fan-in: see _imnet_rule
    return "u", None  # torch default: U(+-1/sqrt(fan_in)) weight and bias


def _check_init(state, bars):
    """Bounds hold for every parameter; the std of the pooled values,
    each divided by its rule's std, is 1 within 5 %, per rule."""
    pooled = {}
    for name, v in state.items():
        kind, scale = bars[name]
        v = np.asarray(v, np.float64).ravel()
        if kind == "0":
            assert not v.any(), name
            continue
        if kind == "u":
            assert np.abs(v).max() <= scale * (1 + 1e-6), name
            std = scale / math.sqrt(3)
        else:
            std = scale
        pooled.setdefault(kind + name.rsplit(".", 1)[-1], []).append(v / std)
    for key, vs in pooled.items():
        s = np.concatenate(vs).std()
        assert abs(s - 1) <= 0.05, (key, s)


def _bars(state):
    """Each parameter's rule, fan-ins read from the torch-layout shapes."""
    bars, imnets = {}, {}
    for name, v in state.items():
        r = _rule(name, tuple(v.shape))
        if r is None:
            net = name.split(".")[0]
            imnets.setdefault(net, []).append(name)
            continue
        if r == ("u", None):
            w = state[name.rsplit(".", 1)[0] + ".weight"]
            r = ("u", 1 / math.sqrt(math.prod(w.shape[1:])))
        bars[name] = r
    for net, names in imnets.items():
        last = max(int(n.split(".")[2]) for n in names)
        for name in names:
            i = int(name.split(".")[2])
            w = state[name.rsplit(".", 1)[0] + ".weight"]
            n = w.shape[1]
            if name.endswith("bias"):
                bars[name] = ("u", 1 / math.sqrt(n))
            else:
                bars[name] = ("u", 1 / n if i == 0
                              else math.sqrt(6 / n) / 30)
        assert last >= 3
    return bars


def test_init_model_draws_the_jax_distributions():
    """The rule table holds for the JAX package's own init (nf 16) and for
    ``init_model_`` on the full-width model; the same generator seed gives
    the same weights."""
    jm = JLunaTokis(nf=16, groups=2, front_RBs=2, back_RBs=2)
    x = jnp.zeros((1, 2, 16, 16, 3))
    t0 = jnp.asarray([0.5])
    jp = jax.jit(lambda k: jm.init(k, x, t0, method=jm.full_init))(
        jax.random.PRNGKey(0))
    jstate = {k: v.numpy() for k, v in
              jax_params_to_state_dict(jax.device_get(jp)).items()}
    _check_init(jstate, _bars(jstate))

    net = LunaTokis()  # full width: nf 64, 5 + 40 blocks
    init_model_(net, torch.Generator().manual_seed(0))
    state = {k: v.numpy() for k, v in net.state_dict().items()}
    _check_init(state, _bars(state))
    again = init_model_(LunaTokis(), torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in
               zip(net.state_dict().values(), again.state_dict().values()))


def test_validator_probes_an_eval_copy(tmp_path):
    """The validator renders one dev scene, probes its own eval copy of the
    net with the kernel on (the training net stays as it is), logs a scale
    probe beside its bicubic bar, and scores what it is given."""
    from stif_tpu_torch.train.validation import Validator

    m = _model(tmp_path)
    v = Validator(m.net, root=str(tmp_path / "val"), n_scenes=1,
                  device="cpu", scale_probes=[2])
    assert v.net is not m.net and all(
        s.fused for s in v.net.modules() if isinstance(s, Siren))
    assert not any(s.fused for s in m.net.modules() if isinstance(s, Siren))
    assert not any(p.requires_grad for p in v.net.parameters())
    first = v.validate(m.net.state_dict())
    assert set(first) == {"t0_psnr", "t05_psnr", "t0_ssim", "t05_ssim",
                          "mean_psnr", "score", "x2_t0", "x2_bi_t0"}
    assert all(np.isfinite(x) for x in first.values())
    assert first["score"] == first["t0_psnr"] + first["t05_psnr"]
    m.optimize_parameters()
    second = v.validate(m.net.state_dict())
    assert second["score"] != first["score"]
    assert second["x2_bi_t0"] == first["x2_bi_t0"]  # computed once
