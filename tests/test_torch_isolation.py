"""The port stands alone: importing ``stif_tpu_torch`` and every submodule
loads no ``jax``, ``flax`` or ``stif_tpu`` module, and no source of the port
(or ``chip_smoke.py``, or the port's scripts ``scripts/test_video_torch.py``,
``scripts/eval_model_torch.py`` and ``scripts/train_torch.py``) imports
one."""

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
    assert int(n_modules) >= 51
    assert bad == "[]"


def test_sources_import_no_jax():
    pattern = re.compile(
        r"^\s*(?:import|from)\s+(%s)(?:\.|\s|$)" % "|".join(FORBIDDEN),
        re.MULTILINE)
    sources = sorted((ROOT / "stif_tpu_torch").rglob("*.py"))
    sources += [ROOT / "chip_smoke.py",
                ROOT / "scripts" / "test_video_torch.py",
                ROOT / "scripts" / "eval_model_torch.py",
                ROOT / "scripts" / "train_torch.py"]
    assert len(sources) >= 56
    for path in sources:
        hits = pattern.findall(path.read_text())
        assert not hits, f"{path} imports {hits}"
