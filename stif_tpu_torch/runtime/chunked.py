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
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from stif_tpu_torch.ops.coords import make_coord
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
    unless ``device`` says otherwise)."""

    def __init__(self, model: torch.nn.Module, chunk_size: int = 65536,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.chunk = chunk_size

    def decode(self, feat_t, inp, times, out_size: Tuple[int, int],
               hr_inp_upsample: bool = False) -> np.ndarray:
        """feat_t: ``gen_feat`` output (B, T, H, W, nf); inp: the model
        input (B, N, H, W, 3); times (nt,) or (B, nt). Returns a numpy
        (nt, B, HH, WW, 3)."""
        HH, WW = out_size
        Q = HH * WW
        C = min(self.chunk, Q)
        n_steps = math.ceil(Q / C)
        Qp = n_steps * C
        dev, m = self.device, self.model
        with torch.inference_mode():
            feat, inp_cat, hr_inp = m._decode_prep(
                torch.as_tensor(feat_t, device=dev),
                torch.as_tensor(inp, device=dev), hr_inp_upsample)
            B = feat.shape[0]
            coord = make_coord((HH, WW), device=dev).clamp(-1 + _EPS, 1 - _EPS)
            coord = _pad_rows(coord, Qp)
            base_grid = _pad_rows(
                torch.from_numpy(_base_grid_xy(HH, WW)).to(dev), Qp)

            # pass 1: stages A+B; the HR field is written in place
            hrfeat_full, flow_chunks = None, []
            for i in range(n_steps):
                cc = coord[None, i * C:(i + 1) * C].expand(B, C, 2)
                hrf, flw = m.decode_chunk_ab(feat, inp_cat, hr_inp, cc, times)
                if hrfeat_full is None:
                    hrfeat_full = hrf.new_empty(hrf.shape[0], Qp, hrf.shape[2])
                hrfeat_full[:, i * C:(i + 1) * C] = hrf
                flow_chunks.append(flw)
            ntB = hrfeat_full.shape[0]
            hrfeat_full = hrfeat_full[:, :Q].reshape(ntB, HH, WW, -1)

            # the bicubic skip source, computed once, gathered per chunk
            skip_hr = m._skip_source(inp_cat, (HH, WW))

            # pass 2: stages C+D from the full field
            out = np.empty((ntB, Qp, 3), np.float32)
            for i in range(n_steps):
                rgb = m.decode_chunk_cd(
                    hrfeat_full, feat, hr_inp, flow_chunks[i],
                    base_grid[i * C:(i + 1) * C], times, (HH, WW),
                    skip_hr=skip_hr)
                out[:, i * C:(i + 1) * C] = rgb.cpu().numpy()
        return out[:, :Q].reshape(ntB // B, B, HH, WW, 3)
