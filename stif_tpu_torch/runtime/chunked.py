"""Memory-bounded chunked decoding (port of ``stif_tpu/runtime/chunked.py``).

A full-grid decode holds every gathered field and SIREN output of the whole
(nt, HH, WW) query set at once; a production frame does not fit. The
chunked decoder cuts the query axis, which every stage treats row by row:

  pass 1 (per chunk): stages A+B -> HR feature chunk + flow chunk
  assemble          : the full HR feature field, on the device
  pass 2 (per chunk): stages C+D gathering from the full field -> RGB chunk,
                      moved to the host

Queries are padded to a chunk multiple with the last coordinate and cropped
after. The result equals the unchunked decode: the chunk boundaries cut only
independent queries. Peak memory is the full HR feature field plus one
chunk's intermediates.

With a ``mesh`` whose ``mesh_axis`` is > 1, each step covers ``n_par``
chunks, chunk j on the axis's device j with a replica of the model there:
pass 1 gathers the HR feature chunks onto the first device, pass 2
replicates the full field (and the bicubic skip source) to every device.
The chunks of one step are dispatched device after device before their
results are gathered, so that the devices work at once; peak memory per
device still follows the chunk size. Two handles of one card drive the same dispatch
on that card.
"""

from __future__ import annotations

import copy
import math
from typing import Optional, Tuple

import numpy as np
import torch

from stif_tpu_torch.ops.coords import make_coord
from stif_tpu_torch.parallel.mesh import Mesh
from stif_tpu_torch.runtime.pipeline import resolve_device

_EPS = 1e-6


def _base_grid_xy(HH: int, WW: int) -> np.ndarray:
    """(HH*WW, 2) ``align_corners=True`` lattice values in (x, y) order."""
    gx = np.linspace(-1.0, 1.0, WW, dtype=np.float32)
    gy = np.linspace(-1.0, 1.0, HH, dtype=np.float32)
    g = np.stack(np.meshgrid(gx, gy, indexing="xy"), axis=-1)
    return g.reshape(-1, 2)


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """(Q, C) -> (n, C), repeating the last row."""
    if x.shape[0] == n:
        return x
    return torch.cat([x, x[-1:].expand(n - x.shape[0], x.shape[1])], 0)


class ChunkedDecoder:
    """Chunked full-grid decode of a ``LunaTokis`` on one device (CUDA
    unless ``device`` says otherwise), or over the ``mesh_axis`` devices of
    a ``mesh`` (``device`` is then not read). A mesh whose axis has size 1
    is the same as none."""

    def __init__(self, model: torch.nn.Module, chunk_size: int = 65536,
                 device=None, mesh: Optional[Mesh] = None,
                 mesh_axis: str = "model"):
        self.mesh = (mesh if mesh is not None
                     and mesh.shape.get(mesh_axis, 1) > 1 else None)
        self.mesh_axis = mesh_axis
        self.n_par = self.mesh.shape[mesh_axis] if self.mesh else 1
        if self.mesh is not None:
            self.devices = [resolve_device(d)
                            for d in self.mesh.axis_devices(mesh_axis)]
        else:
            self.devices = [resolve_device(device)]
        self.device = self.devices[0]
        self.model = model.to(self.device).eval()
        self.chunk = chunk_size
        # one replica of the model per distinct device of the axis
        self._replicas = {str(self.device): self.model}
        for dev in self.devices[1:]:
            if str(dev) not in self._replicas:
                self._replicas[str(dev)] = copy.deepcopy(self.model).to(dev)

    def decode(self, feat_t, inp, times, out_size: Tuple[int, int],
               hr_inp_upsample: bool = False) -> np.ndarray:
        """feat_t: ``gen_feat`` output (B, T, H, W, nf); inp: the model
        input (B, N, H, W, 3); times (nt,) or (B, nt). Returns a numpy
        (nt, B, HH, WW, 3)."""
        HH, WW = out_size
        Q = HH * WW
        # one step covers n_par chunks, chunk j on device j
        C = min(self.chunk, math.ceil(Q / self.n_par))
        S = C * self.n_par
        n_steps = math.ceil(Q / S)
        Qp = n_steps * S
        dev0, m = self.device, self.model
        with torch.inference_mode():
            feat, inp_cat, hr_inp = m._decode_prep(
                torch.as_tensor(feat_t, device=dev0),
                torch.as_tensor(inp, device=dev0), hr_inp_upsample)
            B = feat.shape[0]
            coord = make_coord((HH, WW), device=dev0).clamp(-1 + _EPS,
                                                            1 - _EPS)
            coord = _pad_rows(coord, Qp)
            base_grid = _pad_rows(
                torch.from_numpy(_base_grid_xy(HH, WW)).to(dev0), Qp)
            # per device: its replica and the prepared inputs
            parts = [(self._replicas[str(d)], feat.to(d), inp_cat.to(d),
                      hr_inp.to(d), coord.to(d), base_grid.to(d),
                      times.to(d) if torch.is_tensor(times) else times)
                     for d in self.devices]

            # pass 1: stages A+B; the HR field is assembled on device 0
            hrfeat_full, flow_chunks = None, []
            for i in range(n_steps):
                step = []
                for j, (r, f, ic, hi, co, _, t) in enumerate(parts):
                    lo = i * S + j * C
                    cc = co[None, lo:lo + C].expand(B, C, 2)
                    step.append(r.decode_chunk_ab(f, ic, hi, cc, t))
                for j, (hrf, flw) in enumerate(step):
                    if hrfeat_full is None:
                        hrfeat_full = hrf.new_empty(hrf.shape[0], Qp,
                                                    hrf.shape[2], device=dev0)
                    lo = i * S + j * C
                    hrfeat_full[:, lo:lo + C] = hrf.to(dev0)
                    flow_chunks.append(flw)
            ntB = hrfeat_full.shape[0]
            hrfeat_full = hrfeat_full[:, :Q].reshape(ntB, HH, WW, -1)

            # the bicubic skip source, computed once, gathered per chunk
            skip_hr = m._skip_source(inp_cat, (HH, WW))
            fields = [(hrfeat_full.to(d),
                       None if skip_hr is None else skip_hr.to(d))
                      for d in self.devices]

            # pass 2: stages C+D from the full field, replicated
            out = np.empty((ntB, Qp, 3), np.float32)
            for i in range(n_steps):
                step = []
                for j, (r, f, _, hi, _, bg, t) in enumerate(parts):
                    lo = i * S + j * C
                    hrf, sk = fields[j]
                    step.append(r.decode_chunk_cd(
                        hrf, f, hi, flow_chunks[i * self.n_par + j],
                        bg[lo:lo + C], t, (HH, WW), skip_hr=sk))
                for j, rgb in enumerate(step):
                    lo = i * S + j * C
                    out[:, lo:lo + C] = rgb.cpu().numpy()
        return out[:, :Q].reshape(ntB // B, B, HH, WW, 3)
