"""The port stands alone: importing ``stif_tpu_torch`` and every submodule
(``parallel/``, the data, ops and utils modules, ``runtime/bench.py`` and
``runtime/profile.py`` among them) and executing every script
``scripts/*_torch.py`` (the supervisor, the bench, the profile and the host
tools among them) loads no ``jax``, ``flax`` or ``stif_tpu`` module, and no
source of the port, ``chip_smoke.py`` or those scripts imports one."""

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "stif_tpu")

_PROBE = """
import importlib, pkgutil, sys
import stif_tpu_torch
names = [m.name for m in pkgutil.walk_packages(stif_tpu_torch.__path__,
                                                "stif_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import importlib.util, pathlib
for path in sorted(pathlib.Path("scripts").glob("*_torch.py")):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    names.append(path.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {forbidden!r})
print(len(names))
print(bad)
"""


def test_import_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(forbidden=set(FORBIDDEN))],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.strip().splitlines()
    assert int(n_modules) >= 76
    assert bad == "[]"


def test_sources_import_no_jax():
    pattern = re.compile(
        r"^\s*(?:import|from)\s+(%s)(?:\.|\s|$)" % "|".join(FORBIDDEN),
        re.MULTILINE)
    sources = sorted((ROOT / "stif_tpu_torch").rglob("*.py"))
    scripts = sorted((ROOT / "scripts").glob("*_torch.py"))
    assert {p.name for p in scripts} >= {
        "test_video_torch.py", "eval_model_torch.py", "train_torch.py",
        "train_supervisor_torch.py", "bench_torch.py",
        "profile_bench_torch.py", "decode_decompose_torch.py",
        "offset_stats_torch.py", "export_checkpoint_torch.py",
        "dev_bicubic_bar_torch.py", "make_vimeo_lmdb_torch.py",
        "aggregate_eval_torch.py"}
    sources += [ROOT / "chip_smoke.py"] + scripts
    assert len(sources) >= 78
    for path in sources:
        hits = pattern.findall(path.read_text())
        assert not hits, f"{path} imports {hits}"
