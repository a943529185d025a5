"""The port's scripts on the CPU. ``scripts/test_video_torch.py``: three
tiny frames in, HR / bicubic / LR files out, at the script's own model
(full width) with random weights. ``scripts/eval_model_torch.py``: a tiny
config and a ``.pth`` written by the test, one scene, the JSON record of
``scripts/eval_model.py``."""

import json

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from torch_parity import NUM_THREADS  # importing it caps PyTorch's threads

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "test_video_torch.py"


def _write_frames(folder: Path, n: int, hw):
    folder.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        img = (rng.random(hw + (3,)) * 255).astype(np.uint8)
        cv2.imwrite(str(folder / f"{i:03d}.png"), img)


def _main(script=SCRIPT):
    spec = importlib.util.spec_from_file_location(script.stem, script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def test_script_writes_outputs(tmp_path):
    """16x24 frames, degraded x2 to 8x12, two times per pair at x4."""
    _write_frames(tmp_path / "in" / "clip", 3, (16, 24))
    out = subprocess.run(
        [sys.executable, str(SCRIPT), "--input", str(tmp_path / "in"),
         "--output", str(tmp_path / "out"), "--times", "2", "--device", "cpu"],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS=str(NUM_THREADS)))
    assert out.returncode == 0, out.stderr
    assert "clip: pair 1 -> 2 frames" in out.stdout
    base = tmp_path / "out" / "clip"
    assert sorted(p.name for p in (base / "LR").iterdir()) == [
        "000.png", "001.png"]
    assert cv2.imread(str(base / "LR" / "000.png")).shape == (8, 12, 3)
    for sub in ("HR", "bicubic"):
        assert sorted(p.name for p in (base / sub).iterdir()) == [
            "0.jpg", "1.jpg", "2.jpg", "3.jpg"]
        assert cv2.imread(str(base / sub / "3.jpg")).shape == (32, 48, 3)


def test_script_no_degrade_and_folders(tmp_path):
    _write_frames(tmp_path / "in" / "a", 2, (8, 8))
    _write_frames(tmp_path / "in" / "b", 2, (8, 8))
    _main()(["--input", str(tmp_path / "in"), "--output",
             str(tmp_path / "out"), "--times", "1", "--scale", "2",
             "--folders", "b", "--no-degrade", "--device", "cpu"])
    assert not (tmp_path / "out" / "a").exists()
    assert cv2.imread(str(tmp_path / "out" / "b" / "HR" / "0.jpg")).shape == (
        16, 16, 3)
    assert cv2.imread(str(tmp_path / "out" / "b" / "LR" / "000.png")).shape \
        == (8, 8, 3)


def test_script_rejects_params_and_needs_a_gpu(tmp_path):
    """``--params`` and ``--checkpoint`` are two sources of the weights:
    given both, the script refuses. Without ``--device cpu`` the script
    raises where there is no GPU."""
    _write_frames(tmp_path / "in" / "a", 2, (8, 8))
    main = _main()
    with pytest.raises(SystemExit):
        main(["--input", str(tmp_path / "in"), "--params", "x",
              "--checkpoint", "y"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            main(["--input", str(tmp_path / "in"), "--output",
                  str(tmp_path / "out")])


# ------------------------------------------------- scripts/eval_model_torch.py

EVAL_SCRIPT = ROOT / "scripts" / "eval_model_torch.py"
# the keys of the record ``scripts/eval_model.py`` writes
EVAL_KEYS = {
    "protocol", "provenance", "checkpoint_step", "gather_dtype", "mlp_dtype",
    "stagec", "decode_mode", "rgb_skip", "psnr_y", "ssim_y", "mean_psnr_y",
    "mean_ssim_y", "psnr_y_by_time", "ssim_y_by_time", "avg_window_time_s",
    "wall_s", "baseline_bicubic", "x8_temporal"}


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    """A tiny ``LIIF`` config (``rgb_skip: bicubic``) and a ``.pth`` of
    seeded random weights for it."""
    from stif_tpu_torch.models import LunaTokis

    root = tmp_path_factory.mktemp("eval_script")
    cfg = root / "tiny.yml"
    cfg.write_text(
        "name: tiny\nscale: 4\nnetwork_G:\n  which_model_G: LIIF\n"
        "  nf: 8\n  nframes: 6\n  groups: 2\n  front_RBs: 1\n"
        "  back_RBs: 1\n  rgb_skip: bicubic\n")
    torch.manual_seed(0)
    model = LunaTokis(nf=8, groups=2, front_RBs=1, back_RBs=1)
    pth = root / "tiny.pth"
    torch.save({"module." + k: v for k, v in model.state_dict().items()},
               pth)
    return root, cfg, pth


def test_eval_script_record(tiny_checkpoint):
    """One scene, the scale sweep at x2, the x16 protocols and a knob, in a
    process of its own, as a user runs it."""
    root, cfg, pth = tiny_checkpoint
    out = subprocess.run(
        [sys.executable, str(EVAL_SCRIPT), "-opt", str(cfg), "--pth",
         str(pth), "--scenes", "1", "--eval-root", str(root / "data"),
         "--scale-sweep", "2", "--x16", "--stagec-dedup", "--out",
         str(root / "EVAL.json"), "--device", "cpu"],
        capture_output=True, text=True, timeout=900, cwd=root,
        env=dict(os.environ, OMP_NUM_THREADS=str(NUM_THREADS)))
    assert out.returncode == 0, out.stderr
    rec = json.loads((root / "EVAL.json").read_text())
    assert set(rec) == EVAL_KEYS | {"scale_sweep", "x16_protocols"}
    assert rec["rgb_skip"] == "bicubic" and rec["decode_mode"] == "decoding"
    assert rec["stagec"] == {"nearest": False, "dedup": True,
                             "dtype": "inherit"}
    assert rec["gather_dtype"] == rec["mlp_dtype"] == "fp32"
    assert list(rec["psnr_y"]) == ["scene0"]
    assert set(rec["psnr_y_by_time"]) == {"t0.5", "t0.0"}
    assert set(rec["baseline_bicubic"]) == {"t0_psnr", "t0_ssim", "t05_psnr",
                                            "t05_ssim"}
    assert len(rec["x8_temporal"]["per_time_psnr_y"]) == 8
    assert len(rec["x8_temporal"]["baseline_frame_hold"][
        "per_time_psnr_y"]) == 8
    assert set(rec["scale_sweep"]) == {"x2"}
    assert set(rec["scale_sweep"]["x2"]) == {
        "t0_psnr", "t0_ssim", "t05_psnr", "t05_ssim", "bi_t0_psnr",
        "bi_t0_ssim"}
    assert set(rec["x16_protocols"]) == {
        "adobe_4x_mean_psnr_rgb", "adobe_4x_mean_ssim_rgb",
        "adobe_liif4x_mean_psnr_y", "adobe_liif4x_mean_ssim_y",
        "bicubic_x16_t0_psnr_rgb"}
    prov = rec["provenance"]
    assert prov["weights"] == str(pth) and len(prov["weights_sha256"]) == 64
    assert np.isfinite(rec["mean_psnr_y"])
    # the bicubic baseline beats random weights; both are real numbers
    assert rec["baseline_bicubic"]["t0_psnr"] > 20


def test_eval_script_baselines_match_jax_script(tiny_checkpoint):
    """The two baselines, which need no model, against those of
    ``scripts/eval_model.py`` on the same folders."""
    root, _, _ = tiny_checkpoint
    spec = importlib.util.spec_from_file_location(
        "eval_model", ROOT / "scripts" / "eval_model.py")
    j_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(j_script)
    spec = importlib.util.spec_from_file_location("eval_model_torch",
                                                  EVAL_SCRIPT)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    gt = script.build_eval_set(str(root / "base"), n_scenes=1, n_frames=10,
                               size=(36, 52))
    got, want = script.bicubic_baseline(gt), j_script.bicubic_baseline(gt)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-3, k
    got = script.frame_hold_x8_baseline(gt)
    want = j_script.frame_hold_x8_baseline(gt)
    np.testing.assert_allclose(got["per_time_psnr"], want["per_time_psnr"],
                               atol=1e-3)
    assert abs(got["mean_psnr"] - want["mean_psnr"]) <= 1e-3


def test_eval_script_flags(tiny_checkpoint):
    """Without ``--pth`` the weights come from ``path.models`` (``--best``,
    ``--step``), which this config does not set: a ``ValueError``.
    ``--platform`` is not ported: refused, not accepted and ignored.
    Without ``--device cpu`` the script raises where there is no GPU."""
    root, cfg, pth = tiny_checkpoint
    main = _main(EVAL_SCRIPT)
    for flag in ([], ["--best"], ["--step", "3"]):
        with pytest.raises(ValueError, match="path.models"):
            main(["-opt", str(cfg), "--scenes", "1", "--eval-root",
                  str(root / "data2"), "--scale-sweep", "", "--device",
                  "cpu"] + flag)
    with pytest.raises(SystemExit):
        main(["-opt", str(cfg), "--pth", str(pth), "--platform", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            main(["-opt", str(cfg), "--pth", str(pth), "--scenes", "1",
                  "--eval-root", str(root / "data2"), "--scale-sweep", ""])


# ----------------------------------------------------- scripts/train_torch.py

TRAIN_SCRIPT = ROOT / "scripts" / "train_torch.py"
TRAIN_YAML = """name: tiny_train
use_tb_logger: true
model: VideoSR_base
scale: 4
datasets:
  train:
    mode: Synthetic
    n_items: 64
    nt: 2
    seed: 5
    interval_choices: [2, 4]
    batch_size: 2
    GT_size: 32
    scale_plan: [[4, 8], [2, 12]]
    n_workers: 1
  val:
    n_scenes: 1
    root: {root}/val
network_G:
  which_model_G: LIIF
  nf: 8
  nframes: 6
  groups: 2
  front_RBs: 1
  back_RBs: 1
  rgb_skip: bicubic
path:
  models: {root}/models
train:
  lr_G: !!float 1e-4
  niter: 4
  warmup_iter: 2
  T_period: [100]
  restarts: []
  restart_weights: []
  eta_min: !!float 1e-7
  grad_clip: !!float 1e6
  ema_decay: 0.9
  val_freq: 4
logger:
  print_freq: 1
  save_checkpoint_freq: 2
"""


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """``train_torch.py --device cpu`` for 4 steps in a process of its own,
    then ``--resume`` to step 6 in this one."""
    root = tmp_path_factory.mktemp("train_script")
    cfg = root / "tiny_train.yml"
    cfg.write_text(TRAIN_YAML.format(root=root))
    out = subprocess.run(
        [sys.executable, str(TRAIN_SCRIPT), "-opt", str(cfg), "--device",
         "cpu"], capture_output=True, text=True, timeout=900, cwd=root,
        env=dict(os.environ, OMP_NUM_THREADS=str(NUM_THREADS)))
    assert out.returncode == 0, out.stderr
    first = sorted(os.listdir(root / "models"))
    last = _main(TRAIN_SCRIPT)(["-opt", str(cfg), "--steps", "6",
                                "--resume", "--device", "cpu"])
    return root, cfg, first, last


def test_train_script_runs_and_resumes(trained_run):
    from stif_tpu_torch.utils.tb import read_events

    root, _, first, last = trained_run
    models = root / "models"
    assert {"checkpoint_2.pth", "checkpoint_4.pth", "ema_params_4.pth",
            "best.json", "val_curve.jsonl", "train.log"} <= set(first)
    assert last == 6
    log = (models / "train.log").read_text()
    assert "resumed at step 4" in log and "done at step 6" in log
    assert "step 5 loss" in log and "step 1 loss" in log
    curve = [json.loads(line) for line in
             (models / "val_curve.jsonl").read_text().splitlines()]
    # keep-best seeded at step 0, then every val_freq, then at the end
    assert [r["step"] for r in curve] == [0, 4, 6]
    assert all(np.isfinite(r["score"]) for r in curve)
    best = json.loads((models / "best.json").read_text())
    assert os.path.exists(best["path"])
    names = set(os.listdir(models))
    assert {"checkpoint_6.pth", "ema_params_6.pth"} <= names
    assert "ema_params_2.pth" not in names  # EMA kept two deep
    tags = {e.get("tag") for f in os.listdir(models / "tb")
            for e in read_events(str(models / "tb" / f))}
    assert {"train/loss", "train/grad_norm", "val/score",
            "val/ema_score"} <= tags


def test_train_script_flags(trained_run, tmp_path):
    """``--parallel`` outside ``torch.distributed.run`` (no process group
    in the environment) raises rather than training alone. Without
    ``--device cpu`` the script raises where there is no GPU."""
    _, cfg, _, _ = trained_run
    main = _main(TRAIN_SCRIPT)
    with pytest.raises(RuntimeError, match="process group"):
        main(["-opt", str(cfg), "--parallel", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            main(["-opt", str(cfg), "--steps", "1"])


@pytest.mark.parametrize("flag,step", [(["--best"], None),
                                       (["--step", "4"], 4), ([], 6)])
def test_eval_script_reads_the_run(trained_run, flag, step):
    """``--best`` loads the keep-best weights, ``--step`` a checkpoint,
    nothing the latest checkpoint; the record names the step."""
    root, cfg, _, _ = trained_run
    rec = _main(EVAL_SCRIPT)(["-opt", str(cfg), "--scenes", "1",
                              "--eval-root", str(root / "eval"),
                              "--scale-sweep", "", "--device", "cpu"]
                             + flag)
    best = json.loads((root / "models" / "best.json").read_text())
    want = best["step"] if step is None else step
    assert rec["checkpoint_step"] == want
    assert rec["provenance"]["weights_step"] == want
    assert np.isfinite(rec["mean_psnr_y"])
