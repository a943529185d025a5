"""The port's measuring entry points and host tools on the CPU, at a small
config (nf 8, groups 2, 1 + 1 residual blocks, LR 16x16, nt 2, DCN offsets
perturbed by ``torch_parity.random_params``):

- the bench's b1 window (``runtime/bench.py``) against the JAX model under
  ``bench.py``'s quantisation: 5e-5 on the float frames, 1 LSB on the
  uint8 frames; the batched modes against per-pair, ``tsplit`` and chunked
  against ``full`` (1 LSB);
- ``window_flops`` against ``FlopCounterMode`` on the plain path, op kind
  by op kind, exactly, and its SIREN part at the deployed shapes;
- ``InferencePipeline.stream``'s order (window i + 1 launched before
  window i is fetched) and its per-launch hook;
- ``scripts/bench_torch.py``, ``scripts/profile_bench_torch.py`` and
  ``scripts/decode_decompose_torch.py`` end to end with ``--device cpu``; the bench line carries every key of
  ``bench.py``'s; a failure in any mode exits non-zero with no line;
- the fp32 peak named only for a card of its table;
- the profile's trace analysis on a hand-made trace with device events;
- ``offset_stats_torch`` against the JAX ``dcn_shift_stats`` on the same
  offsets; ``aggregate_eval_torch``, ``dev_bicubic_bar_torch`` and
  ``make_vimeo_lmdb_torch`` against their ``tools/`` counterparts; the
  exported ``.pth`` loading strictly into the port's model and
  ``tools/torch_mirror.py``'s (under the mirror's name for the SIRENs' last
  layer)."""

import ast
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import jax
import jax.numpy as jnp

from stif_tpu.convert import flax_params_to_torch_state
from stif_tpu.models import LunaTokis as JLunaTokis
from stif_tpu.ops.deform_conv import dcn_shift_stats as j_dcn_shift_stats

from stif_tpu_torch.models import LunaTokis
from stif_tpu_torch.runtime import bench, profile
from stif_tpu_torch.runtime.pipeline import InferencePipeline
from torch_parity import NUM_THREADS, random_params

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
ARCH = dict(nf=8, groups=2, front_RBs=1, back_RBs=1)
SKIP = dict(rgb_skip=True, rgb_skip_bicubic=True)
LR = (16, 16)
TIMES = bench.times_for(2)
FLOAT_BAR = 5e-5
LSB = 1
TINY = ["--device", "cpu", "--weights", "none", "--lr-h", "16", "--lr-w",
        "16", "--nf", "8", "--front-rbs", "1", "--back-rbs", "1",
        "--n-times", "2", "--iters", "2"]
ENV = dict(os.environ, OMP_NUM_THREADS=str(NUM_THREADS))


def _script(name):
    path = SCRIPTS / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(args, timeout=300, env=ENV, cwd=ROOT):
    return subprocess.run([sys.executable] + [str(a) for a in args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=timeout, env=env)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """JAX params of the small config with perturbed DCN offsets, the same
    weights as a reference-schema ``.pth``, and the port's bench model
    built from it."""
    jm = JLunaTokis(**ARCH, **SKIP)
    params = random_params(jm, jnp.zeros((1, 2) + LR + (3,)),
                           jnp.asarray(TIMES), seed=11, method=jm.full_init)
    pth = tmp_path_factory.mktemp("bench") / "tiny_G.pth"
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in flax_params_to_torch_state(params).items()}, pth)
    model = bench.build("cpu", pth, bench.Knobs(), **ARCH)
    pairs = bench.draw_pairs(np.random.default_rng(3), 4, LR)[:, 0]
    return jm, params, pth, model, pairs


@pytest.fixture(scope="module")
def b1(tiny):
    _, _, _, model, pairs = tiny
    return bench.bench_b1(model, pairs, TIMES, warmup=1)


def test_b1_window_matches_jax(tiny, b1):
    """The streamed b1 window (uint8 through the pipeline's copy path) and
    its float frames against the JAX model and ``bench.py:126-130``."""
    jm, params, _, model, pairs = tiny
    fwd = jax.jit(lambda p, x, t: jm.apply(p, x, t))
    t = jnp.asarray(TIMES)
    for pair, got_u8 in zip(pairs, b1["outs"]):
        want = np.asarray(fwd(params, pair[None], t))[:, 0]
        want_u8 = np.asarray(jnp.round(jnp.clip(want, 0, 1) * 255)
                             .astype(jnp.uint8))
        with torch.inference_mode():
            got = model(torch.from_numpy(pair[None]),
                        torch.tensor(TIMES))[:, 0].numpy()
        np.testing.assert_allclose(got, want, atol=FLOAT_BAR)
        assert got_u8.dtype == np.uint8 and got_u8.shape == want_u8.shape
        assert np.abs(got_u8.astype(int) - want_u8).max() <= LSB
    assert b1["fps"] > 0 and b1["window_device_ms"] is None
    assert b1["siren_launches"] == b1["dcn_launches"] == 0  # the CPU: plain


def test_stream_launches_one_window_ahead(tiny, b1):
    """``stream`` launches window i + 1 before it fetches window i, enters
    the hook around each launch only, and gives the frames ``bench_b1``
    streamed."""
    _, _, _, model, pairs = tiny
    pipe = InferencePipeline(bench.Quantized(model), scale=bench.SCALE,
                             bucket=1, device="cpu")
    log = []

    @contextlib.contextmanager
    def around():
        log.append("launch")
        yield
        log.append("launched")

    outs = []
    for out in pipe.stream((pipe.stage(p, TIMES) for p in pairs[:3]),
                           around):
        log.append("fetched")
        outs.append(out)
    assert log == ["launch", "launched"] * 2 + ["fetched", "launch",
                                                "launched", "fetched",
                                                "fetched"]
    for got, want in zip(outs, b1["outs"]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name, model", [
    ("NVIDIA H100 80GB HBM3", "H100 SXM"), ("NVIDIA H100 PCIe", "H100 PCIe"),
    ("NVIDIA H100 NVL", None), ("NVIDIA A100-SXM4-80GB", None)])
def test_card_model_names_only_a_known_card(name, model):
    if model is None:
        with pytest.raises(ValueError, match="no fp32 peak"):
            bench.card_model(name)
    else:
        assert bench.card_model(name) == model
        assert bench.card_model(name) in bench.FP32_PEAKS


@pytest.mark.parametrize("mode", ["full", "tsplit", "1000"])
def test_batched_modes(tiny, b1, mode):
    """Batches of two pairs against the b1 frames of the same pairs, and
    ``tsplit`` and chunked (1000 queries: 5 steps, the last padded)
    against ``full``."""
    _, _, _, model, pairs = tiny
    groups = pairs.reshape((2, 2) + pairs.shape[1:])
    got = bench.bench_batched(model, groups, TIMES, mode, warmup=0)
    assert got["fps"] > 0 and got["peak_gib"] is None
    for i, out in enumerate(got["outs"]):
        assert out.dtype == np.uint8 and out.shape == (2, 2, 64, 64, 3)
        for j in range(2):
            d = np.abs(out[:, j].astype(int) - b1["outs"][2 * i + j]).max()
            assert d <= LSB
    if mode != "full":
        full = bench.bench_batched(model, groups, TIMES, "full", warmup=0)
        for a, b in zip(got["outs"], full["outs"]):
            assert np.abs(a.astype(int) - b).max() <= LSB


def test_chunked_mode_times_no_quantisation(tiny, monkeypatch):
    """The chunked mode's clock holds the decodes and no quantisation: its
    float frames are quantised after the clock stops, as ``bench.py``'s
    chunked mode times none, and its uint8 frames are those of ``full``
    within 1 LSB."""
    import types

    _, _, _, model, pairs = tiny
    groups = pairs.reshape((2, 2) + pairs.shape[1:])
    full = bench.bench_batched(model, groups, TIMES, "full", warmup=0)
    events, quantize, clock = [], bench.quantize, bench.time.perf_counter

    def counted_quantize(x):
        events.append("quantize")
        return quantize(x)

    def counted_clock():
        events.append("clock")
        return clock()

    monkeypatch.setattr(bench, "quantize", counted_quantize)
    monkeypatch.setattr(bench, "time",
                        types.SimpleNamespace(perf_counter=counted_clock))
    got = bench.bench_batched(model, groups, TIMES, "1000", warmup=1)
    assert events == ["clock", "clock"] + ["quantize"] * len(groups)
    for a, b in zip(got["outs"], full["outs"]):
        assert a.dtype == np.uint8
        assert np.abs(a.astype(int) - b).max() <= LSB


@pytest.mark.parametrize("B, hw, nt, skip", [
    (1, (16, 16), 2, "bicubic"), (2, (16, 24), 3, "none"),
    (1, (12, 20), 1, "lr")])
def test_window_flops_match_flop_counter(B, hw, nt, skip):
    """Each part of ``flop_parts`` equals what ``FlopCounterMode`` counts
    for its op kind on the plain path of ``LunaTokis.forward``."""
    model = bench.build("cpu", None, bench.Knobs(rgb_skip=skip), **ARCH)
    x = torch.rand(B, 2, *hw, 3)
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        model(x, torch.linspace(0, 1, nt))
    counted = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    parts = bench.flop_parts(model, B, nt, (4 * hw[0], 4 * hw[1]))
    assert parts == {"convs": counted["aten.convolution"],
                     "dcn": counted["aten.addmm"],
                     "resize": counted["aten.bmm"],
                     "siren": counted["aten.mm"]}
    assert bench.window_flops(model, B, nt, (4 * hw[0], 4 * hw[1])) == \
        fc.get_total_flops()


def test_siren_flops_at_the_deployed_window():
    """2 x 208,448 weights x 1,966,080 rows (8 x 384 x 640)."""
    model = LunaTokis(**SKIP)
    parts = bench.flop_parts(model, 1, bench.N_TIMES, (384, 640))
    assert parts["siren"] == 2 * 208_448 * 1_966_080 == 819_650_887_680


def _bench_py_keys():
    """The keys of the dict literal ``rec`` in ``bench.py``'s ``main``."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "rec"
                        for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no rec literal in bench.py")


@pytest.fixture(scope="module")
def bench_line():
    out = _run([SCRIPTS / "bench_torch.py"] + TINY + ["--repeats", "2"])
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def test_bench_cli_line(bench_line):
    rec = bench_line
    assert rec["metric"] == "frames_per_sec" and rec["unit"] == "frames/s"
    assert rec["value"] == max(rec["b1_fps"], rec["batched_fps"])
    assert len(rec["b1_fps_runs"]) == len(rec["batched_fps_runs"]) == 2
    assert rec["b1_fps"] == pytest.approx(np.median(rec["b1_fps_runs"]),
                                          abs=1e-3)
    assert rec["device"]["platform"] == "cpu"
    # no device numbers from a CPU run, and no baseline at another size
    assert rec["mfu"] is None and rec["card"] is None
    assert rec["peak_gib"] == {"b1": None, "batched": None}
    assert rec["vs_baseline"] is None
    assert (rec["gather_dtype"], rec["mlp_dtype"], rec["encode_splitk"]) == \
        ("fp32", "fp32", False)
    assert rec["workload_tflops"] >= 0 and set(rec["stages"]) == {
        "encode_s", "decode_s", "transfer_s"}


def test_bench_line_has_every_key_of_bench_py(bench_line):
    keys = _bench_py_keys()
    assert len(keys) == 20
    assert keys <= set(bench_line)


@pytest.mark.parametrize("case", ["batched_mode_fails", "no_gpu"])
def test_bench_cli_failure_exits_without_a_line(case):
    """A failure after the b1 mode has run (an unreadable chunk size), or
    no GPU for the default device: non-zero exit, nothing on stdout."""
    if case == "no_gpu":
        args = [SCRIPTS / "bench_torch.py", "--weights", "none"]
        env = dict(ENV, CUDA_VISIBLE_DEVICES="")
    else:
        args = [SCRIPTS / "bench_torch.py"] + TINY + ["--repeats", "1"]
        env = dict(ENV, BENCH_CHUNK="bogus")
    out = _run(args, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert ("invalid literal" if case != "no_gpu" else "no CUDA device") \
        in out.stderr


def test_profile_cli(tmp_path):
    trace, line = tmp_path / "trace.json", tmp_path / "line.json"
    out = _run([SCRIPTS / "profile_bench_torch.py"] + TINY
               + ["--trace", trace, "--out", line])
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert json.loads(line.read_text()) == rec
    assert set(rec["ranges"]) == profile.LABELS
    # the CPU: the stage marks' time per window (the host's), no device
    # fields
    assert rec["stages"]["encode"] > 0 and rec["stages"]["decode"] > 0
    assert rec["stages"]["encode"] >= rec["stages"]["encode.front"]
    assert rec["device_busy_ms"] is None and rec["idle_share"] is None
    assert rec["blocking"]["per_window"] == 0
    assert trace.exists() and rec["trace"] == str(trace)


DECODE_CASES = ["stageA_nearest", "stageB_bilinear", "feat_imnet",
                "flow_imnet", "warp_grids", "stageC_hr", "stageC_lr",
                "encode_imnet", "stageD_skip", "decode_full"]


def test_decode_decompose_cli():
    """A header, one line per case, then the sum of the stages against the
    whole decode."""
    out = _run([SCRIPTS / "decode_decompose_torch.py"] + TINY)
    assert out.returncode == 0, out.stderr
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    head, cases, total = lines[0], lines[1:-1], lines[-1]
    assert head["tool"] == "decode_decompose_torch"
    assert (head["lr_hw"], head["n_times"], head["queries"]) == (
        [16, 16], 2, 64 * 64)
    assert [c["case"] for c in cases] == DECODE_CASES
    assert all(c["ms"] > 0 for c in cases)
    stages = sum(c["ms"] for c in cases[:-1])
    assert total["case"] == "sum_of_stages"
    assert total["ms"] == pytest.approx(stages, abs=0.01)
    assert total["of_decode_full"] == pytest.approx(
        total["ms"] / cases[-1]["ms"], abs=1e-3)


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_analyze_a_trace_with_device_events():
    """Attribution by launch to the innermost range, busy time as a union,
    gaps with the host's open event, blocking calls, on a hand-made
    trace (microseconds)."""
    events = [
        _ev("user_annotation", "window", 0, 1000),
        _ev("user_annotation", "launch.replay", 10, 490),
        _ev("user_annotation", "launch.copy_in", 50, 100),
        _ev("user_annotation", "fetch.wait", 510, 390),
        _ev("cpu_op", "aten::conv", 60, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 62, 2, corr=1),
        _ev("kernel", "k_conv", 100, 80, tid=7, corr=1),
        _ev("cpu_op", "aten::to", 200, 60),
        _ev("cuda_runtime", "cudaMemcpyAsync", 205, 5, corr=100),
        _ev("gpu_memcpy", "Memcpy HtoD", 206, 3, tid=7, corr=100),
        _ev("cuda_runtime", "cudaStreamSynchronize", 210, 45),
        _ev("cuda_runtime", "cudaLaunchKernel", 300, 2, corr=2),
        _ev("kernel", "k_relu", 303, 17, tid=7, corr=2),
        _ev("cpu_op", "aten::mm", 600, 20),
        _ev("cuda_runtime", "cudaLaunchKernel", 605, 2, corr=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 615, 1, corr=4),
        _ev("kernel", "k_mm", 610, 90, tid=7, corr=3),
        _ev("kernel", "k_mm", 700, 60, tid=7, corr=4),
        _ev("cuda_runtime", "cudaEventSynchronize", 950, 40),
        # launched before the window: not the window's work
        _ev("kernel", "k_before", 5, 20, tid=7, corr=9),
        # another thread's host events are not read
        _ev("cuda_runtime", "cudaDeviceSynchronize", 400, 5, tid=2),
    ]
    rec = profile.analyze(events, wall_ms=1.0, n_gaps=2)
    assert rec["device_busy_ms"] == pytest.approx(0.25)
    assert rec["device_span_ms"] == pytest.approx(0.66)
    assert rec["idle_share"] == pytest.approx(0.75)
    r = rec["ranges"]
    assert (r["launch.copy_in"]["device_ms"],
            r["launch.copy_in"]["launches"]) == (0.08, 1)
    assert (r["launch.replay"]["device_ms"],
            r["launch.replay"]["launches"]) == (0.02, 2)
    assert (r["fetch.wait"]["device_ms"], r["fetch.wait"]["launches"]) == (
        0.15, 2)
    assert (r["launch.replay"]["host_ms"] == 0.49
            and r["stage.pad"]["launches"] == 0)
    assert rec["top_ops"][0] == {"name": "k_mm", "ms": 0.15, "count": 2}
    assert [g["ms"] for g in rec["gaps"]] == [0.29, 0.094]
    assert rec["idle_by_gap"] == {
        "under_50us": {"ms": 0.026, "gaps": 1},
        "50us_to_1ms": {"ms": 0.384, "gaps": 2},
        "1ms_and_over": {"ms": 0.0, "gaps": 0}}
    # 320-610: Python only until aten::mm starts at 600
    assert rec["gaps"][0] == {"ms": 0.29, "at_ms": 0.32,
                              "range": "launch.replay",
                              "host_op_share": 0.034,
                              "longest_cuda_call": "cudaLaunchKernel",
                              "longest_python_ms": 0.28,
                              "call_after_python": "aten::mm", "next": "k_mm",
                              "launched_by": "aten::mm"}
    # 209-303: in the copy and its sync until 260, a launch at 300-302
    g = rec["gaps"][1]
    assert (g["host_op_share"], g["longest_python_ms"],
            g["call_after_python"], g["launched_by"],
            g["longest_cuda_call"]) == (
        0.564, 0.04, "cudaLaunchKernel", None, "cudaStreamSynchronize")
    b = rec["blocking"]
    assert b["calls"] == {"cudaStreamSynchronize": 1,
                          "cudaDeviceSynchronize": 0,
                          "cudaEventSynchronize": 1, "cudaMemcpy": 0}
    assert b["per_window"] == 2 and b["memcpy_async_then_sync"] == 1
    assert b["host_blocked_ms"] == pytest.approx(0.085)


def test_stage_ranges_leave_the_model_as_it_was(tiny, monkeypatch):
    """The stage marks the model makes (``utils/trace.py``) change nothing
    it computes, set no hook or attribute on it, and are there: the
    output with the marks made equals the output with them made inert,
    bitwise, and the marked window adds to the eager table's ``encode``
    and ``decode``."""
    from stif_tpu_torch.utils import trace

    _, _, _, model, pairs = tiny
    x, t = torch.from_numpy(pairs[:1]), torch.tensor(TIMES)
    with monkeypatch.context() as inert:
        inert.setattr(trace.Marks, "open", lambda self, slot: None)
        inert.setattr(trace.Marks, "close", lambda self, slot: None)
        with torch.inference_mode():
            want = model(x, t)
    before = trace.eager_stats("cpu")["stages"]
    with torch.inference_mode():
        got = model(x, t)
    after = trace.eager_stats("cpu")["stages"]
    assert torch.equal(got, want)
    for stage in ("encode", "decode"):
        assert after[stage]["n"] == before.get(stage, {"n": 0})["n"] + 1
    assert "decode" not in vars(model) and "gen_feat" not in vars(model)
    assert not any(m._forward_hooks or m._forward_pre_hooks
                   for m in model.modules())


def test_offset_stats_match_jax(tiny):
    """Each DCN call's ``max_shift`` against the JAX ``dcn_shift_stats`` on
    the same offsets; 42 calls (7 pyramids of 6)."""
    _, _, _, model, pairs = tiny
    mod = _script("offset_stats_torch")
    calls = mod.capture_offsets(model, torch.from_numpy(pairs[:1]))
    assert len(calls) == 42
    for name, off in calls:
        row = mod.site_stats(name, off, 0.9999)
        want = float(j_dcn_shift_stats(jnp.asarray(off.numpy())))
        assert row["max_shift"] == pytest.approx(round(want, 2), abs=1e-6)
        assert row["max_shift"] > 1.0  # the perturbed offsets deform
        assert row["tap_spread_max"] >= row["tap_spread_med"] >= 0


def test_offset_stats_script_on_trained_weights(capsys):
    out = _script("offset_stats_torch").main(["--device", "cpu",
                                              "--size", "8"])
    assert out["n_dcn_calls"] == 42 and len(out["sites"]) == 42
    assert out["global_max_shift"] == max(s["max_shift"]
                                          for s in out["sites"])
    assert out["dense_ok_bound"] >= out["global_max_shift"]


def _rec(t0, t05, extra=None):
    rec = {"protocol": "vid4_space_time_x4",
           "psnr_y_by_time": {"t0.0": t0, "t0.5": t05},
           "ssim_y_by_time": {"t0.0": 0.9, "t0.5": 0.7},
           "baseline_bicubic": {"t0_psnr": 35.405, "t0_ssim": 0.899,
                                "t05_psnr": 28.158, "t05_ssim": 0.692}}
    rec.update(extra or {})
    return rec


@pytest.mark.parametrize("case", ["four_modes_and_knobs", "missing_optional",
                                  "corrupt_optional"])
def test_aggregate_eval_matches_the_tool(tmp_path, case):
    """The inputs of ``tests/test_aggregate_eval.py`` (and the stage-C knob
    records) through both tools: the same artifact."""
    inputs = {
        "four_modes_and_knobs": {
            "plain": _rec(35.1, 29.8, {"scale_sweep": {"x2": {}}}),
            "bf16": _rec(35.104, 29.797), "le": _rec(35.3, 30.0),
            "le-se": _rec(36.0, 30.2), "stagec-dedup": _rec(35.1, 29.8),
            "stagec-fp8": _rec(35.09, 29.79)},
        "missing_optional": {"plain": _rec(35.5, 29.6)},
        "corrupt_optional": {"plain": _rec(35.0, 29.0), "bf16": None},
    }[case]
    args = []
    for name, rec in inputs.items():
        p = tmp_path / f"{name}.json"
        p.write_text("{truncated" if rec is None else json.dumps(rec))
        args += [f"--{name}", p]
    if case == "missing_optional":
        args += ["--bf16", tmp_path / "missing.json"]
    arts = []
    for tool in (ROOT / "tools" / "aggregate_eval.py",
                 SCRIPTS / "aggregate_eval_torch.py"):
        out = tmp_path / f"{tool.stem}.out.json"
        res = _run([tool] + args + ["--out", out])
        assert res.returncode == 0, res.stderr
        if case == "corrupt_optional":
            assert "skipping unparseable" in res.stderr
        arts.append(json.loads(out.read_text()))
    assert arts[0] == arts[1]


@pytest.mark.parametrize("which", ["latest", "best"])
def test_exported_pth_loads_strictly(tmp_path, which):
    """A training run's checkpoint (or keep-best weights) of the small
    config exported as a ``.pth``: it loads with ``strict=True`` into the
    port's ``LunaTokis`` and into ``tools/torch_mirror.py``'s, bitwise."""
    from stif_tpu_torch.train.checkpoints import CheckpointManager
    from stif_tpu_torch.train.validation import BestTracker

    sys.path.insert(0, str(ROOT / "tools"))
    from torch_mirror import LunaTokis as MirrorLunaTokis

    models = tmp_path / "models"
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "name": "export", "scale": 4, "model": "VideoSR",
        "path": {"models": str(models)},
        "network_G": {"which_model_G": "LIIF", "nframes": 6, **ARCH,
                      "rgb_skip": "bicubic"}}))
    state = bench.build("cpu", None, bench.Knobs(), **ARCH).state_dict()
    state = {k: v + 0.01 * torch.randn_like(v) for k, v in state.items()}
    if which == "best":
        BestTracker(str(models)).update(30, {"score": 1.0}, state)
        flag = ["--best"]
    else:
        CheckpointManager(str(models)).save(20, state, {})
        flag = []
    out = tmp_path / "latest_G.pth"
    _script("export_checkpoint_torch").main(["-opt", str(cfg), "--out",
                                             str(out)] + flag)
    sd = torch.load(out, map_location="cpu", weights_only=True)
    assert set(sd) == set(state)
    assert all(torch.equal(sd[k], state[k]) for k in state)
    LunaTokis(**ARCH).load_state_dict(sd, strict=True)
    # the mirror calls each SIREN's last layer ``final`` where the schema
    # has ``net.{last}``: the rename its own loader (``load_flax_params``)
    # makes
    last = {"feat_imnet": 3, "flow_imnet": 3, "encode_imnet": 4}
    mirror = {}
    for k, v in sd.items():
        net = k.split(".")[0]
        if net in last and k.startswith(f"{net}.net.{last[net]}."):
            k = f"{net}.final." + k.split(".")[-1]
        mirror[k] = v
    MirrorLunaTokis(nf=8, groups=2, front_RBs=1,
                    back_RBs=1).load_state_dict(mirror, strict=True)


def test_lmdb_tool_round_trip(tmp_path):
    """Two septuplets of 20x24 PNGs: the port's tool writes the same
    ``data.mdb`` as ``tools/make_vimeo_lmdb.py``, and its keys and values
    read back through the port's reader."""
    import cv2

    from stif_tpu_torch.data.lmdb_io import LmdbReader

    rng = np.random.default_rng(5)
    root = tmp_path / "sept"
    want = {}
    for a, b in (("00001", "0001"), ("00001", "0002")):
        folder = root / a / b
        folder.mkdir(parents=True)
        for i in range(1, 8):
            img = (rng.random((20, 24, 3)) * 255).astype(np.uint8)
            cv2.imwrite(str(folder / f"im{i}.png"), img)
            want[f"{a}_{b}_{i}".encode()] = img.tobytes()
    _script("make_vimeo_lmdb_torch").main(["--root", str(root), "--out",
                                           str(tmp_path / "port")])
    res = _run([ROOT / "tools" / "make_vimeo_lmdb.py", "--root", root,
                "--out", tmp_path / "tool"])
    assert res.returncode == 0, res.stderr
    port_db = (tmp_path / "port" / "data.mdb").read_bytes()
    assert port_db == (tmp_path / "tool" / "data.mdb").read_bytes()
    reader = LmdbReader(str(tmp_path / "port"))
    try:
        assert sorted(reader.keys()) == sorted(want)
        assert all(reader.get(k) == v for k, v in want.items())
    finally:
        reader.close()


def test_dev_bicubic_bar_matches_the_tool(tmp_path):
    """The tool writes under its working directory's ``runs/val_data``;
    the port's takes ``--root``."""
    rec = _script("dev_bicubic_bar_torch").main(
        ["--root", str(tmp_path / "port")])
    res = _run([ROOT / "tools" / "dev_bicubic_bar.py"], cwd=tmp_path,
               env=dict(ENV, PYTHONPATH=str(ROOT)))
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == rec
    assert json.loads((tmp_path / "port" / "BICUBIC_BAR.json").read_text()) \
        == rec
    assert rec["n_frames"] == 18


def test_b1_splits_its_window_by_the_marks(b1):
    """``bench_b1``'s ``stages``: per streamed window, the marks'
    ``encode`` and ``decode`` (host seconds on the CPU, inside the
    window's wall) and the ``fetch.copy`` span (none on the CPU, whose
    frames are the output itself)."""
    st = b1["stages"]
    assert set(st) == {"encode_s", "decode_s", "transfer_s"}
    assert st["encode_s"] > 0 and st["decode_s"] > 0
    assert st["encode_s"] + st["decode_s"] < b1["window_s"]
    assert st["transfer_s"] == 0
