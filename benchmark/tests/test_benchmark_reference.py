"""The benchmark's plain reference held to the port's plain path on the CPU
at a small size: STIF's forward, TMNet's forward, three train steps, and
the MATLAB-bicubic matrices."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import ops, stif, tmnet, train

ARCH = {"nf": 8, "groups": 2, "front_RBs": 1, "back_RBs": 2}
DRAW = {"offset_px": 2.5}


def port(which: str, **extra):
    from stif_tpu_torch.models.factory import define_g

    net = define_g({"network_G": {"which_model_G": which, **ARCH, **extra}})
    shapes = {k: v.shape for k, v in net.state_dict().items()}
    state = weights.draw(shapes, DRAW, 11, "cpu")
    net.load_state_dict(state)
    return net.eval(), state


@pytest.mark.parametrize("times", [[0.0, 0.4, 1.0], [[0.1, 0.9], [0.5, 0.2]]])
def test_stif_forward(times):
    net, state = port("LIIF", rgb_skip="bicubic")
    B = len(times) if isinstance(times[0], list) else 1
    x = torch.rand(B, 2, 12, 16, 3, generator=torch.Generator().manual_seed(1))
    t = torch.tensor(times)
    with torch.no_grad():
        want = net(x, t, out_size=(48, 64))
        got = stif.forward(state, ARCH, x, t, (48, 64), block=500)
    assert got.shape == want.shape
    assert (got - want).abs().max() < 1e-5


def test_tmnet_forward():
    net, state = port("TMNet")
    x = torch.rand(1, 4, 12, 16, 3, generator=torch.Generator().manual_seed(2))
    t = torch.tensor([[1 / 6, 0.5, 5 / 6]])
    with torch.no_grad():
        want = net(x, t)
        got = tmnet.forward(state, ARCH, x, t)
    assert got.shape == want.shape == (1, 13, 48, 64, 3)
    assert (got - want).abs().max() < 1e-5


def test_train_steps():
    from stif_tpu_torch.train.video_sr_model import VideoSRModel

    cfg = {"lr_G": 1e-4, "beta1": 0.9, "beta2": 0.99, "warmup_iter": 2,
           "T_period": [30, 30], "restarts": [30], "restart_weights": [0.5],
           "eta_min": 1e-7, "pixel_criterion": "cb", "pixel_weight": 1.0,
           "grad_clip": 5e2, "ema_decay": 0.9}
    vsr = VideoSRModel({"network_G": {"which_model_G": "LIIF", **ARCH,
                                      "rgb_skip": "bicubic"},
                        "train": cfg}, device="cpu", compiled=False)
    vsr.init_params(None, None)
    shapes = {k: v.shape for k, v in vsr.net.state_dict().items()}
    state = weights.draw(shapes, DRAW, 3, "cpu")
    ema0 = weights.lagging(state, 0.1, 3, "cpu")  # a resumed run's EMA
    with torch.no_grad():
        vsr.net.load_state_dict(state)
        vsr.ema.load(ema0)
    rng = np.random.default_rng(0)
    batches = [{"LQs": rng.random((3, 2, 8, 8, 3), dtype=np.float32),
                "GT": rng.random((3, 2, 8 * s, 8 * s, 3), dtype=np.float32),
                "times": rng.random((3, 2)).astype(np.float32)}
               for s in (2, 3, 4)]
    losses = []
    for b in batches:
        vsr.feed_data(b)
        losses.append(vsr.optimize_parameters())
    ref = train.train_steps(
        state, ARCH, cfg,
        [{"lqs": torch.from_numpy(b["LQs"]), "gt": torch.from_numpy(b["GT"]),
          "times": torch.from_numpy(b["times"])} for b in batches], block=2,
        ema0=ema0)
    for got, want, norm in zip(losses, ref["loss"], ref["grad_norm"]):
        assert abs(got["loss"] - want) <= 1e-5 * abs(want)
        assert abs(got["grad_norm"] - norm) <= 1e-4 * norm
    net = dict(vsr.net.named_parameters())
    moved = [k for k in net if (ref["params"][k] - state[k]).abs().max() > 0]
    assert moved
    for k in net:
        assert torch.allclose(net[k].detach(), ref["params"][k], rtol=0,
                              atol=1e-6), k
        assert torch.allclose(vsr.ema.params[k], ref["ema"][k], rtol=0,
                              atol=1e-6), k


@pytest.mark.parametrize("n_in,n_out", [(180, 720), (720, 180), (48, 768),
                                        (704, 44), (88, 352), (8, 32)])
def test_matlab_matrix(n_in, n_out):
    from stif_tpu_torch.ops.resize import _matlab_resize_matrix

    want = _matlab_resize_matrix(n_in, n_out, n_out / n_in, True)
    assert np.array_equal(ops.matlab_matrix(n_in, n_out), want)
