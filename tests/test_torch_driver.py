"""The port's video script ``scripts/test_video_torch.py`` on the CPU: three
tiny frames in, HR / bicubic / LR files out, at the script's own model
(full width) with random weights."""

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


def _main():
    spec = importlib.util.spec_from_file_location("test_video_torch", SCRIPT)
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
    """``--params`` is not ported: it is refused, not accepted and ignored.
    Without ``--device cpu`` the script raises where there is no GPU."""
    _write_frames(tmp_path / "in" / "a", 2, (8, 8))
    main = _main()
    with pytest.raises(SystemExit):
        main(["--input", str(tmp_path / "in"), "--params", "x"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            main(["--input", str(tmp_path / "in"), "--output",
                  str(tmp_path / "out")])
