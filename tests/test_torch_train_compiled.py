"""The compiled train step (``trainer.make_train_step(programs=)``,
``VideoSRModel(compiled=)``) and the validator's compiled probes on the CPU.

The CPU has no CUDA graphs, so the step's ``ProgramCache`` gets the test
double of the capture step, ``torch_parity.replay_double``: the program
runs the step at its capture and again at every replay, as a graph runs its
kernels, and the cache puts the state the step updates back as it was
after the warm-up and after the capture, as it does on the card. Everything
else is the code the card runs: the keys and the state's addresses, the
static inputs, the warm-up, the one replay per step.

Small config of ``tests/test_train.py:133-137`` (LIIF, nf 8, groups 2,
1 + 1 blocks, ``rgb_skip`` bicubic), B 2, nt 2, two buckets: LR 8x8 to GT
32x32 (x4) and LR 8x8 to GT 16x16 (x2). Bars: compiled against eager
bitwise; against the JAX train step those of ``tests/test_torch_train.py``.
"""

import numpy as np
import pytest
import torch

from stif_tpu_torch.nn.siren import Siren, set_fused
from stif_tpu_torch.ops import capture
from stif_tpu_torch.runtime import InferencePipeline, ProgramCache
from stif_tpu_torch.train import trainer
from stif_tpu_torch.train.validation import Validator
from stif_tpu_torch.train.video_sr_model import VideoSRModel
from test_torch_train import CFG, _port_step, reference  # noqa: F401
from torch_parity import replay_double

NET = dict(which_model_G="LIIF", nf=8, nframes=6, groups=2, front_RBs=1,
           back_RBs=1, rgb_skip="bicubic")
BUCKETS = {"x4": 32, "x2": 16}  # GT size for LR 8x8


def double_cache():
    return ProgramCache("cpu", capture=replay_double)


def _opt(tmp_path, **train):
    tr = dict(lr_G=1e-3, warmup_iter=-1, T_period=[100], restarts=[],
              restart_weights=[], eta_min=1e-7, grad_clip=1e6,
              ema_decay=0.9)
    tr.update(train)
    return {"model": "VideoSR_base", "network_G": dict(NET),
            "path": {"models": str(tmp_path / "models")}, "train": tr}


def _batch(bucket="x4", seed=0):
    rng = np.random.default_rng(seed)
    g = BUCKETS[bucket]
    return {"LQs": rng.random((2, 2, 8, 8, 3)).astype(np.float32),
            "GT": rng.random((2, 2, g, g, 3)).astype(np.float32),
            "times": np.asarray([[0.0, 0.5], [1.0, 0.25]], np.float32)}


def _model(tmp_path, compiled, sub="a", seed=0, **train):
    opt = _opt(tmp_path / sub, **train)
    m = VideoSRModel(opt, device="cpu", compiled=compiled)
    b = _batch()
    m.init_params(b["LQs"], b["times"], seed=seed)
    return m


def _pair(tmp_path, **train):
    """(eager, compiled) models from the same init, each with a directory
    of its own; the compiled one's cache."""
    cache = double_cache()
    return (_model(tmp_path, False, "eager", **train),
            _model(tmp_path, cache, "compiled", **train), cache)


def _step(m, bucket="x4", seed=0):
    m.feed_data(_batch(bucket, seed))
    return m.optimize_parameters()


def _state(m):
    """Everything a step updates, as copies: parameters, gradients, the
    optimizer's moments and count, the EMA."""
    opt = m.optimizer.state_dict()
    return {"step": m.step,
            "params": {k: v.clone() for k, v in m.net.state_dict().items()},
            "grads": {k: p.grad.clone()
                      for k, p in m.net.named_parameters()},
            "moments": {i: {k: v.clone() for k, v in s.items()}
                        for i, s in opt["state"].items()},
            "ema": {k: v.clone() for k, v in m.ema_params.items()}}


def _assert_bitwise(a, b):
    assert a["step"] == b["step"]
    for key in ("params", "grads", "ema"):
        assert a[key].keys() == b[key].keys()
        for k in a[key]:
            assert torch.equal(a[key][k], b[key][k]), (key, k)
    assert a["moments"].keys() == b["moments"].keys()
    for i in a["moments"]:
        for k, v in a["moments"][i].items():
            assert torch.equal(v, b["moments"][i][k]), ("moments", i, k)


def test_compiled_steps_equal_eager_bitwise(tmp_path):
    """Three steps, x4, x2 and x4 again: loss, grad norm, every parameter,
    its gradient, the moments and count, and the EMA bitwise the eager
    model's; one capture per bucket, the third step a replay of the
    first's program."""
    eager, comp, cache = _pair(tmp_path)
    for bucket, seed in (("x4", 0), ("x2", 1), ("x4", 2)):
        want, got = _step(eager, bucket, seed), _step(comp, bucket, seed)
        assert got == want, bucket
        assert np.isfinite(got["loss"]) and np.isfinite(got["grad_norm"])
    _assert_bitwise(_state(comp), _state(eager))
    assert cache.captures == 2
    assert sorted(st["replays"] for st in cache.stats()) == [1, 2]
    assert float(comp.optimizer.count) == 3.0


def test_compiled_step_matches_jax(reference):  # noqa: F811
    """The compiled step against the JAX train step at
    ``test_torch_train.py``'s bars: loss rtol 1e-5, pre-clip grad norm rtol
    1e-4, every parameter's gradient (read from ``p.grad`` after the
    replay) within 1e-4 of its largest entry; three steps' losses within
    rtol 1e-3."""
    model, _, batch = _port_step(reference)
    cfg = trainer.TrainConfig(**CFG)
    opt, _ = trainer.make_optimizer(model.parameters(), cfg)
    cache = double_cache()
    step = trainer.make_train_step(model, opt, cfg, programs=cache)
    losses = []
    for count in range(3):
        out = step(batch, count)
        losses.append(out["loss"].item())
        if count == 0:
            np.testing.assert_allclose(losses[0], reference["loss"],
                                       rtol=1e-5)
            np.testing.assert_allclose(out["grad_norm"].item(),
                                       reference["grad_norm"], rtol=1e-4)
            want = reference["grads"]
            for name, p in model.named_parameters():
                w = want[name].numpy()
                assert np.abs(p.grad.numpy() - w).max() <= \
                    1e-4 * np.abs(w).max(), name
    np.testing.assert_allclose(losses, reference["losses"], rtol=1e-3)
    assert cache.captures == 1 and cache.stats()[0]["replays"] == 3
    # the replays' phase marks (no EMA here): one of each a replay
    assert {k: v["n"] for k, v in cache.stats()[0]["stages"].items()} == {
        "train.forward": 3, "train.backward": 3, "train.update": 3}


def test_test_and_validation_between_steps_capture_nothing(tmp_path):
    """``VideoSRModel.test`` (``set_fused`` on, then off) and a validation
    (the validator's copy has its own flags) between two steps: the second
    step replays the first one's program, and equals the eager model's."""
    eager, comp, cache = _pair(tmp_path)
    _step(eager)
    _step(comp)
    for m in (eager, comp):
        out = m.test()
        assert out.shape == (2, 2, 32, 32, 3)
        v = Validator(m.net, root=str(tmp_path / "val"), n_scenes=1,
                      n_frames=4, size=(32, 48), device="cpu")
        assert np.isfinite(v.validate(m.net.state_dict())["score"])
    assert _step(comp, seed=1) == _step(eager, seed=1)
    assert cache.captures == 1 and cache.stats()[0]["replays"] == 2
    _assert_bitwise(_state(comp), _state(eager))


def test_set_fused_on_the_training_net_makes_a_new_key(tmp_path):
    """A switch that changes what the training net launches makes a new
    key: the next step captures anew and the old program is dropped; a
    round trip (on, then off) with no step between keeps the key."""
    _, comp, cache = _pair(tmp_path)
    _step(comp)
    set_fused(comp.net, True)
    set_fused(comp.net, False)
    _step(comp)
    assert cache.captures == 1
    set_fused(comp.net, True)
    assert all(s.fused for s in comp.net.modules() if isinstance(s, Siren))
    _step(comp)
    assert cache.captures == 2 and len(cache.programs) == 1


@pytest.mark.parametrize("load", ["resume_training", "load_pth"])
def test_loads_then_a_step_equal_eager_bitwise(tmp_path, load):
    """``resume_training`` (params, moments, count, EMA from checkpoint 2)
    and ``load_pth`` (params, EMA re-seeded) copy into the tensors the
    step's program writes: the next step replays it (no new capture) and
    the state equals the eager model's after the same calls bitwise."""
    eager, comp, cache = _pair(tmp_path)
    for m in (eager, comp):
        for seed in range(2):
            _step(m, seed=seed)
        if load == "resume_training":
            assert m.save() == 2
        else:
            path = m.save_network(2)
        _step(m, seed=2)
        if load == "resume_training":
            assert m.resume_training() == 2
        else:
            m.load_pth(path)
    _assert_bitwise(_state(comp), _state(eager))
    assert _step(comp, seed=3) == _step(eager, seed=3)
    _assert_bitwise(_state(comp), _state(eager))
    assert cache.captures == 1 and cache.stats()[0]["replays"] == 4


def test_state_put_in_place_of_the_captured_is_a_new_key(tmp_path):
    """A tensor of the step's state replaced (not loaded in place) is a new
    key: the step captures anew and never writes the memory it let go of."""
    _, comp, cache = _pair(tmp_path)
    _step(comp)
    key = next(iter(comp.ema_params))
    comp.ema_params[key] = comp.ema_params[key].clone()
    _step(comp)
    assert cache.captures == 2 and len(cache.programs) == 2


def test_failed_capture_raises_and_leaves_the_state(tmp_path):
    """A capture that fails raises out of the step; no eager step stands in
    for it, and the state is as it was before the step."""
    def broken(fn, inputs, cache):
        raise RuntimeError("capture failed")

    m = _model(tmp_path, ProgramCache("cpu", capture=broken))
    m.feed_data(_batch())
    before = {k: v.clone() for k, v in m.net.state_dict().items()}
    ema = {k: v.clone() for k, v in m.ema_params.items()}
    with pytest.raises(RuntimeError, match="capture failed"):
        m.optimize_parameters()
    assert m.programs.programs == {} and capture.current() is None
    for k, v in m.net.state_dict().items():
        assert torch.equal(v, before[k]) and torch.equal(
            m.ema_params[k], ema[k]), k
    assert float(m.optimizer.count) == 0.0


def test_compiled_option(tmp_path):
    """None: graphs on a card, the eager step on the CPU; True raises off a
    card; data-parallel with True or a cache raises ``NotImplementedError``
    naming the ROADMAP item, with None or False it is eager (it needs a
    process group); a compiled step's replays mark its four phases in its
    program's table."""
    assert VideoSRModel(_opt(tmp_path), device="cpu").programs is None
    assert VideoSRModel(_opt(tmp_path), device="cpu",
                        compiled=False).programs is None
    with pytest.raises(ValueError, match="CUDA"):
        VideoSRModel(_opt(tmp_path), device="cpu", compiled=True)
    for compiled in (True, double_cache()):
        with pytest.raises(NotImplementedError, match="item 23"):
            VideoSRModel(_opt(tmp_path), device="cpu", parallel=True,
                         compiled=compiled)
    with pytest.raises(RuntimeError, match="process group"):
        VideoSRModel(_opt(tmp_path), device="cpu", parallel=True)
    m = _model(tmp_path, double_cache())
    for _ in range(3):
        _step(m)
    (st,) = m.programs.stats()
    assert st["replays"] == 3
    assert {k: v["n"] for k, v in st["stages"].items()} == {
        k: 3 for k in ("train.forward", "train.backward", "train.update",
                       "train.ema")}
    assert all(v["device_ms"] > 0 for v in st["stages"].values())


def test_validator_replays_its_probe_after_an_in_place_reload(tmp_path):
    """Two validations with other weights loaded in place between them: the
    compiled probes equal the eager ones bitwise, and the second makes no
    capture (the x4 pipeline and the x2 scale probe's sibling)."""
    m = _model(tmp_path, False)
    kw = dict(root=str(tmp_path / "val"), n_scenes=1, n_frames=4,
              size=(32, 48), device="cpu", scale_probes=[2])
    eager = Validator(m.net, compiled=False, **kw)
    cache = double_cache()
    comp = Validator(m.net, compiled=cache, **kw)
    first = comp.validate(m.net.state_dict())
    assert first == eager.validate(m.net.state_dict())
    captures = {k: len(v) for k, v in comp.stats().items()}
    assert captures == {"x4": 1, "x2_probe": 1}
    assert eager.stats() == {"x4": None, "x2_probe": None}
    _step(m)
    second = comp.validate(m.net.state_dict())
    assert second == eager.validate(m.net.state_dict())
    assert second["score"] != first["score"]
    assert cache.captures == 1
    assert comp._probe_pipes[2].programs.captures == 1
    for st in [s for v in comp.stats().values() for s in v]:
        assert st["replays"] >= 2 and st["pool_bytes"] is None


def test_switch_round_trip_keeps_a_pipelines_key(tmp_path):
    """The route is each model's own: a switch on another model leaves a
    pipeline's key as it was, and a round trip on its own model (on, then
    off) replays its program."""
    m = _model(tmp_path, False)
    other = _model(tmp_path, False, sub="b")
    set_fused(m.net, True)
    m.net.eval()
    pipe = InferencePipeline(m.net, device="cpu", compiled=double_cache())
    frames = np.random.default_rng(3).random((2, 8, 8, 3)).astype(np.float32)
    with torch.no_grad():
        want = pipe.render_window(frames, [0.0, 0.5])
        set_fused(other.net, False)
        set_fused(other.net, True)
        set_fused(m.net, False)
        set_fused(m.net, True)
        np.testing.assert_array_equal(pipe.render_window(frames, [0.0, 0.5]),
                                      want)
    assert pipe.programs.captures == 1


@pytest.mark.parametrize("argv,compiled", [([], None), (["--eager"], False)])
def test_train_script_eager_flag(tmp_path, monkeypatch, argv, compiled):
    """``scripts/train_torch.py --eager`` hands ``compiled=False`` to the
    run (the model and the validator); without it, None (graphs on a
    card)."""
    import importlib.util
    import json
    from pathlib import Path

    script = Path(__file__).resolve().parents[1] / "scripts" / "train_torch.py"
    spec = importlib.util.spec_from_file_location("train_torch", script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = {}
    monkeypatch.setattr(mod, "run", lambda opt, **kw: seen.update(kw) or 0)
    cfg = tmp_path / "opt.json"
    cfg.write_text(json.dumps(_opt(tmp_path)))
    mod.main(["-opt", str(cfg), "--device", "cpu"] + argv)
    assert seen["compiled"] is compiled and seen["device"] == "cpu"
