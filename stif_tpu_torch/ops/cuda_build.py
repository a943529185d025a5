"""Build and load the port's CUDA kernels and its host library.

Each ``csrc/<name>.cu`` has a plain C entry point. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``stif_tpu_torch/_build``
(listed in ``.gitignore``) at first use, named by a hash of its source and
of the headers beside it (``csrc/*.cuh``) so an edited kernel or header is
rebuilt, and loaded with ``ctypes``. A ``csrc/<name>.cpp``
(host code, a plain C ABI) is built the same way with ``g++``
(``load_host``); its threads are ``std::thread``s, so it needs no OpenMP
runtime. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-pthread", "-std=c++17")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {home})")
    return path


def library_path(name: str) -> Path:
    """Where kernel ``name`` is built: named by a hash of its source, of
    every header in ``csrc`` (``*.cuh``, which a source may include) and of
    the flags, so that an edit to any of them builds it anew."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns ``{name: compiler log}`` (the
    ``-Xptxas -v`` register / shared-memory / spill report) for the kernels
    compiled by this call. Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]


def host_library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cpp").read_bytes()
    digest = hashlib.sha256(src + " ".join(HOST_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library ``csrc/<name>.cpp``, compiled with ``g++``
    (``$CXX`` when set) at first use. Raises with the compiler's output if
    the build fails."""
    key = f"host:{name}"
    if key not in _loaded:
        out = host_library_path(name)
        if not out.exists():
            cxx = os.environ.get("CXX") or shutil.which("g++")
            if not cxx:
                raise RuntimeError("g++ not found: the host library "
                                   f"{name} cannot be built")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [cxx, *HOST_FLAGS, str(CSRC / f"{name}.cpp"), "-o",
                   str(tmp)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"host library build failed: {name}: {' '.join(cmd)} "
                    f"exited {proc.returncode}\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        _loaded[key] = ctypes.CDLL(str(out))
    return _loaded[key]
