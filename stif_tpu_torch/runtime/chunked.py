"""Memory-bounded chunked decoding (port of ``stif_tpu/runtime/chunked.py``).

A full-grid decode holds every gathered field and SIREN output of the whole
(nt, HH, WW) query set at once; a production frame does not fit. The
chunked decoder cuts the query axis, which every stage treats row by row:

  prep              : the decode's gather sources (``decode_prep``), once
  pass 1 (per chunk): stages A+B (``decode_ab``) -> HR feature chunk + flow
                      chunk, copied into the full HR feature field and the
                      flow field
  skip              : the bicubic skip source, once
  pass 2 (per chunk): stages C+D (``decode_cd``) gathering from the full
                      field -> RGB chunk, copied into the RGB field

and the RGB field comes down to the host once, at the end: one blocking
call per decode. (The JAX package's ``np.asarray`` per chunk bounds host
memory, not the result; the (nt*B, Qp, 3) field is 1/21 of the HR field.)
A chunk's query set (``models/luna_tokis.py:Queries``) is rows of the whole
grid's: its coordinates and its lattice rows. The rows are padded to a chunk
multiple with the last row and cropped after, so every chunk has one shape.
The passes are the full-grid decode's own stages, so the result equals the
unchunked decode: the chunk boundaries cut only independent queries.
Peak memory is the full HR feature field plus one chunk's intermediates.

``compiled``, as ``InferencePipeline`` takes it: on a CUDA device each of
the four passes (prep, A+B, skip, C+D) is a program of the decoder's own
``ProgramCache`` (``runtime/compiled.py``), captured once per chunk shape as
a CUDA graph and replayed for every chunk, as the JAX decoder jits each
pass once and reuses it. Each pass's outputs are copied, on the compute
stream before the next replay, into buffers the decoder owns; the chunk
passes read those buffers (the gather sources, the HR field, the skip
source) as resident inputs, by address. The decoder keeps the
buffers and programs of its newest bucket (the shapes of a decode) between
calls, so that a later decode of that bucket only replays; a new bucket
lets the old one's go. Its own cache gives it a pool of its own: no replay
of the decoder writes over a pipeline program's output that it reads.

With a ``mesh`` whose ``mesh_axis`` is > 1, each step covers ``n_par``
chunks, chunk j on the axis's device j with a replica of the model there,
eagerly (its graphs are not ported yet; ``compiled=True`` raises there):
pass 1 gathers the HR feature chunks onto the first device, pass 2
replicates the full field (and the bicubic skip source) to every device.
The chunks of one step are dispatched device after device before their
results are gathered, so that the devices work at once; peak memory per
device still follows the chunk size. Two handles of one card drive the same
dispatch on that card.
"""

from __future__ import annotations

import copy
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from stif_tpu_torch.models.luna_tokis import Queries, Sources, decode_prep
from stif_tpu_torch.parallel.mesh import Mesh
from stif_tpu_torch.runtime.compiled import ProgramCache, program_cache
from stif_tpu_torch.runtime.pipeline import resolve_device


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """(Q, C) -> (n, C), repeating the last row."""
    if x.shape[0] == n:
        return x
    return torch.cat([x, x[-1:].expand(n - x.shape[0], x.shape[1])], 0)


# the passes with their copied inputs first and their resident ones after,
# as ``ProgramCache.run`` calls them; the sources travel as the tensors of a
# ``Sources`` (the last, ``gather_bc``, is absent in test mode)

def _prep(feat_t, inp, *, hr_inp_upsample):
    s, _ = decode_prep(feat_t, inp, hr_inp_upsample=hr_inp_upsample)
    return tuple(v for v in s if v is not None)


def _ab(model, coord, lattice, times, *sources, size):
    return model.decode_ab(Queries(Sources(*sources), times, size, coord,
                                   lattice))


def _cd(model, coord, lattice, flow, times, field, *rest, size, skip):
    skip_hr, sources = (rest[0], rest[1:]) if skip else (None, rest)
    return model.decode_cd(Queries(Sources(*sources), times, size, coord,
                                   lattice), field, flow, skip_hr)


def _into(buffers: dict, name: str, value: torch.Tensor) -> torch.Tensor:
    """``value`` copied into ``buffers[name]``, made on first use."""
    if name not in buffers:
        buffers[name] = torch.empty_like(value)
    return buffers[name].copy_(value)


def _rows_into(buffers: dict, name: str, chunk: torch.Tensor, lo: int,
               rows: int, device) -> None:
    """A chunk (nt*B, C, c) copied into rows ``lo:lo + C`` of
    ``buffers[name]`` (nt*B, rows, c) on ``device``, made on first use."""
    if name not in buffers:
        buffers[name] = chunk.new_empty(chunk.shape[0], rows, chunk.shape[2],
                                        device=device)
    buffers[name][:, lo:lo + chunk.shape[1]] = chunk


class ChunkedDecoder:
    """Chunked full-grid decode of a ``LunaTokis`` on one device (CUDA
    unless ``device`` says otherwise), or over the ``mesh_axis`` devices of
    a ``mesh`` (``device`` is then not read). A mesh whose axis has size 1
    is the same as none.

    ``compiled``: None replays the passes' CUDA graphs on a CUDA device and
    runs eagerly elsewhere and under a mesh; False runs eagerly; True asks
    for graphs (``ValueError`` off a CUDA device, ``NotImplementedError``
    under a mesh); a ``ProgramCache`` is used as it is (one of its own: the
    decoder clears it when the bucket changes)."""

    def __init__(self, model: torch.nn.Module, chunk_size: int = 65536,
                 device=None, mesh: Optional[Mesh] = None,
                 mesh_axis: str = "model", compiled=None):
        self.mesh = (mesh if mesh is not None
                     and mesh.shape.get(mesh_axis, 1) > 1 else None)
        self.mesh_axis = mesh_axis
        self.n_par = self.mesh.shape[mesh_axis] if self.mesh else 1
        if self.mesh is not None:
            if compiled is True or isinstance(compiled, ProgramCache):
                raise NotImplementedError(
                    "the mesh decode has no CUDA graphs yet (ROADMAP.md "
                    "item 20); pass compiled=None or False with a mesh")
            self.devices = [resolve_device(d)
                            for d in self.mesh.axis_devices(mesh_axis)]
        else:
            self.devices = [resolve_device(device)]
        self.device = self.devices[0]
        self.programs = (None if self.mesh is not None
                         else program_cache(self.device, compiled))
        self.model = model.to(self.device).eval()
        self.chunk = chunk_size
        # one replica of the model per distinct device of the axis
        self._replicas = {str(self.device): self.model}
        for dev in self.devices[1:]:
            if str(dev) not in self._replicas:
                self._replicas[str(dev)] = copy.deepcopy(self.model).to(dev)
        # the newest bucket's key and buffers (compiled only)
        self._bucket: Optional[tuple] = None
        self._buffers: dict = {}

    def _call(self, name: str, fn, model, copied, resident=(), **static):
        """``fn(*copied, *resident, **static)``: eagerly, or the replay of
        its program (see the module docstring)."""
        if self.programs is None:
            return fn(*copied, *resident, **static)
        return self.programs.run(name, fn, copied, model, static, resident)

    def _buffers_of(self, bucket: tuple) -> dict:
        """The buffers the passes' outputs are copied into: a fresh set when
        eager; when compiled, the newest bucket's, kept between calls (the
        programs read them by address), and on a new bucket a new set and
        no program of the old one."""
        if self.programs is None:
            return {}
        if bucket != self._bucket:
            self.programs.clear()
            self._bucket, self._buffers = bucket, {}
        return self._buffers

    def stats(self) -> dict:
        """The programs' stats (None when eager) and the bytes of the
        buffers held between calls."""
        return {"programs": (None if self.programs is None
                             else self.programs.stats()),
                "held_bytes": sum(v.numel() * v.element_size()
                                  for v in self._buffers.values())}

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
            feat_t = torch.as_tensor(feat_t, device=dev0)
            inp = torch.as_tensor(inp, device=dev0)
            # on the device before any program runs: an upload inside a
            # capture would fail it
            t = torch.as_tensor(times, dtype=torch.float32, device=dev0)
            bufs = self._buffers_of((tuple(feat_t.shape), tuple(inp.shape),
                                     tuple(t.shape), (HH, WW),
                                     hr_inp_upsample))
            prep = self._call("prep", _prep, m, (feat_t, inp),
                              hr_inp_upsample=hr_inp_upsample)
            srcs = tuple(_into(bufs, k, v)
                         for k, v in zip(Sources._fields, prep))
            s = Sources(*srcs)
            B = s.feat.shape[0]
            ntB = t.shape[-1] * B
            # the whole grid's query set, whose rows the chunks take
            grid = Queries(s, t, (HH, WW))
            coord = _pad_rows(grid.coord, Qp)
            lattice = _pad_rows(grid.lattice, Qp)
            # per device: its replica, the sources, the rows and the times
            parts = [(self._replicas[str(d)], tuple(v.to(d) for v in srcs),
                      coord.to(d), lattice.to(d), t.to(d))
                     for d in self.devices]

            def rows(co, la, lo):  # one chunk's coordinates and lattice rows
                return co[None, lo:lo + C].expand(B, C, 2), la[lo:lo + C]

            # pass 1: stages A+B; the HR and flow fields are assembled on
            # device 0
            for i in range(n_steps):
                step = []
                for j, (r, sj, co, la, tj) in enumerate(parts):
                    step.append(self._call(
                        "ab", functools.partial(_ab, r), r,
                        rows(co, la, i * S + j * C) + (tj,), sj,
                        size=(HH, WW)))
                for j, (hrf, flw) in enumerate(step):
                    lo = i * S + j * C
                    _rows_into(bufs, "field", hrf, lo, Qp, dev0)
                    _rows_into(bufs, "flow", flw, lo, Qp, dev0)
            field = bufs["field"][:, :Q].reshape(ntB, HH, WW, -1)  # a view

            # the bicubic skip source, computed once, gathered per chunk
            skip_hr = None
            if (getattr(m, "rgb_skip", False)
                    and getattr(m, "rgb_skip_bicubic", False)):
                skip_hr = _into(bufs, "skip", self._call(
                    "skip", m.skip_source, m, (s.inp_cat,), size=(HH, WW)))
            fields = [(field.to(d),
                       () if skip_hr is None else (skip_hr.to(d),))
                      for d in self.devices]

            # pass 2: stages C+D from the full field, replicated
            for i in range(n_steps):
                step = []
                for j, (r, sj, co, la, tj) in enumerate(parts):
                    lo = i * S + j * C
                    hrf, sk = fields[j]
                    flw = bufs["flow"][:, lo:lo + C].to(co.device)
                    step.append(self._call(
                        "cd", functools.partial(_cd, r), r,
                        rows(co, la, lo) + (flw, tj), (hrf,) + sk + sj,
                        size=(HH, WW), skip=bool(sk)))
                for j, rgb in enumerate(step):
                    _rows_into(bufs, "rgb", rgb, i * S + j * C, Qp, dev0)
            # the decode's one wait: cropped on the device, and a copy even
            # on the CPU, whose buffer the next decode may write over
            out = bufs["rgb"][:, :Q].to("cpu", copy=True).numpy()
        return out.reshape(ntB // B, B, HH, WW, 3)
