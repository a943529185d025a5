"""Artifact provenance stamps (the port's own copy of
``stif_tpu/utils/provenance.py``): every eval artifact records exactly which
weights and code produced it.

``stamp(weights=...)`` returns one small dict:
  ``{"weights": path, "weights_sha256": ..., "weights_step": ...,
     "git_commit": ..., "config": ...}``
— sha256 is computed for plain weight files (``.pth``); checkpoint
*directories* get a manifest hash over their file list and sizes (cheap,
stable, and enough to pin identity).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from typing import Optional


def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _sha256_dir_manifest(path: str) -> str:
    """Hash of (relpath, size, mtime-free content head) per file — a cheap
    identity pin for checkpoint dirs without reading gigabytes."""
    h = hashlib.sha256()
    for root, dirs, files in sorted(os.walk(path)):
        dirs.sort()
        for name in sorted(files):
            p = os.path.join(root, name)
            rel = os.path.relpath(p, path)
            try:
                size = os.path.getsize(p)
                with open(p, "rb") as f:
                    head = f.read(4096)
            except OSError:
                continue
            h.update(rel.encode())
            h.update(str(size).encode())
            h.update(head)
    return "manifest:" + h.hexdigest()


def git_commit(repo_dir: Optional[str] = None) -> Optional[str]:
    repo_dir = repo_dir or os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        out = subprocess.run(
            ["git", "-C", repo_dir, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10)
        return out.stdout.strip() or None
    except Exception:
        return None


def stamp(weights: Optional[str] = None, step: Optional[int] = None,
          config: Optional[str] = None) -> dict:
    rec = {"git_commit": git_commit()}
    if config:
        rec["config"] = config
    if step is not None:
        rec["weights_step"] = int(step)
    if weights:
        rec["weights"] = weights
        try:
            if os.path.isfile(weights):
                rec["weights_sha256"] = _sha256_file(weights)
            elif os.path.isdir(weights):
                rec["weights_sha256"] = _sha256_dir_manifest(weights)
        except OSError as e:
            rec["weights_sha256"] = f"unavailable: {e}"
    return rec
