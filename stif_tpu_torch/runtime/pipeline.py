"""Inference pipeline (port of ``stif_tpu/runtime/pipeline.py``): padding,
sliding frame windows, the window renderer and the batched-pair renderer.

The JAX pipeline pads shapes to a ``bucket`` multiple and compiles one
program per bucket, with the forward's shape constants baked in. Here the
bucket sets the same padding, which keeps the output identical to the JAX
pipeline's, one set of constants, and on a CUDA device one compiled program.
The first call of a bucket builds its resize matrices, coordinate and warp
grids and scale vectors and keeps them on the device (``ops/constants.py``),
as a JAX trace bakes them in; it then captures the forward as a CUDA graph
(``runtime/compiled.py``), and every later call of the bucket replays that
graph: one launch from the host in place of the forward's ~2,800. So time a
bucket after one warm-up call. ``render_pairs``' ``ChunkedDecoder`` replays
its passes' graphs the same way, once per chunk. ``compiled=False`` runs the
forward eagerly on the card, and the CPU, which has no graphs, always does.
The inputs go up from pinned memory without a wait.

Each window's host work is a set of spans (``utils/trace.py``), tallied
per window and added to the table of the program the window replays (the
eager table when no program runs): ``stage.pad``, ``stage.upload`` (pin and
the queued copy), ``launch.copy_in`` and ``launch.replay`` (in the
program), ``fetch.wait`` (the wait for the frames' copy, or for the
compute) and ``fetch.copy`` (into the host array returned).
"""

from __future__ import annotations

import contextlib
import inspect
import math
from typing import Callable, ContextManager, Iterable, Iterator, List, \
    Optional, Sequence, Tuple

import numpy as np
import torch

from stif_tpu_torch.runtime.compiled import program_cache
from stif_tpu_torch.utils import trace


def resolve_device(device=None) -> torch.device:
    """The device the pipeline runs on: CUDA unless the caller asks for
    another. Raises when CUDA is asked for (or defaulted to) and no GPU is
    present — the pipeline never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def pad_to_multiple(x: np.ndarray, multiple: int = 4,
                    bucket: int = 1) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Zero-pad (..., H, W, C) so H and W are multiples of
    ``max(multiple, bucket)``. Returns (padded, (H, W) original)."""
    h, w = x.shape[-3], x.shape[-2]
    m = max(multiple, bucket)
    hp = int(m * math.ceil(h / m))
    wp = int(m * math.ceil(w / m))
    pad = [(0, 0)] * (x.ndim - 3) + [(0, hp - h), (0, wp - w), (0, 0)]
    return np.pad(x, pad), (h, w)


def window_plan(skip: bool, n_out: int, len_in: int) -> List[List[List[int]]]:
    """Sliding-window index plans for long sequences (the reference's
    ``test_index_generation``). Returns [input_indices, output_indices]
    windows; with ``skip`` the inputs are every 2nd frame of each
    ``n_out``-frame output window."""
    n_in = 1 + n_out // 2
    if n_in > len_in:
        raise ValueError("input too short for one window")
    plans = []
    if skip:
        right = n_out
        while right <= len_in:
            h_list = [right - n_out + x for x in range(n_out)]
            right += n_out - 1
            plans.append([h_list[::2], h_list])
        if right < len_in - 1:
            h_list = [len_in - n_out + x for x in range(n_out)]
            plans.append([h_list[::2], h_list])
    else:
        right, right_in = n_out, n_in
        while right_in <= len_in:
            h_list = [right - n_out + x for x in range(n_out)]
            l_list = [right_in - n_in + x for x in range(n_in)]
            right += n_out - 1
            right_in += n_in - 1
            plans.append([l_list, h_list])
        if right_in < len_in - 1:
            right = len_in * 2 - 1
            h_list = [right - n_out + x for x in range(n_out)]
            l_list = [len_in - n_in + x for x in range(n_in)]
            plans.append([l_list, h_list])
    return plans


class InferencePipeline:
    """Renders LR frame windows on one device (CUDA unless ``device`` says
    otherwise). ``render_window``, ``stage`` / ``stream`` and
    ``render_sequence`` serve a ``LunaTokis``, which takes ``test=`` and
    ``local_ensemble=`` (the attributes ``test_mode`` and
    ``local_ensemble``, read at each window), and a model whose forward
    takes ``(x, times, out_size)`` only, such as ``LunaTokisTrain``
    (``LIIF_train``): asking such a model for ``test_mode`` or
    ``local_ensemble`` raises ``ValueError``, at construction or at the
    window.
    ``render_pairs`` serves a ``LunaTokis`` (its chunked decode passes) and
    ``render_window_tmnet`` a ``TMNet``; the other variants are called
    directly.

    ``compiled``: None replays one captured CUDA graph per bucket on a CUDA
    device and runs eagerly on the CPU; False runs eagerly; True asks for
    graphs and raises off a CUDA device; a ``ProgramCache`` is used as it is.
    The window's forward, TMNet's and ``render_pairs``' ``gen_feat`` go
    through it; ``render_pairs``' ``ChunkedDecoder`` takes the same choice,
    with a cache of its own (``ProgramCache.sibling``)."""

    def __init__(self, model: torch.nn.Module, scale: int = 4,
                 bucket: int = 16, device=None, test_mode: bool = False,
                 local_ensemble: bool = False, self_ensemble: bool = False,
                 compiled=None):
        self.device = resolve_device(device)
        # the per-bucket programs, one memory pool: replayed in order on
        # this pipeline's compute stream, one window at a time
        self.programs = program_cache(self.device, compiled)
        self.model = model.to(self.device).eval()
        self.scale = scale
        self.bucket = bucket
        # test mode: the decoder reads a bilinear x4 upsample of the inputs
        self.test_mode = test_mode
        # x8 geometric self-ensemble (EDSR dihedral average): not a
        # reference mode; an optional quality / compute trade
        self.self_ensemble = self_ensemble
        # four area-weighted shifted decode passes: a quality / compute trade
        self.local_ensemble = local_ensemble
        # whether the window's forward takes the decode modes above
        takes = inspect.signature(self.model.forward).parameters
        self._takes_modes = "test" in takes and "local_ensemble" in takes
        self._modes()
        # render_pairs' decoder, made anew only when the chunk size changes
        self._chunked = None

    def render_window(self, frames: np.ndarray,
                      times: Sequence[float]) -> np.ndarray:
        """frames: (N, H, W, 3) float32 RGB in [0, 1] ->
        (nt, H*scale, W*scale, 3) float32."""
        if self.self_ensemble:
            return self._render_window_ensemble(frames, times)
        return self._render_window_raw(frames, times)

    def _render_window_raw(self, frames: np.ndarray,
                           times: Sequence[float]) -> np.ndarray:
        return self._fetch(self._launch(frames, times))

    def _launch(self, frames: np.ndarray, times: Sequence[float]):
        """Queue one window's compute and the start of its copy to the
        host (``stage``, then ``_launch_staged``); ``_fetch`` waits for
        it."""
        return self._launch_staged(*self.stage(frames, times))

    def _run(self, name: str, fn, inputs, tally: Optional[trace.Tally] = None,
             **static) -> torch.Tensor:
        """``fn(*inputs, **static)``: the replay of its bucket's program
        when compiled (the program's output, overwritten by its next
        replay), else an eager call. ``tally``: the window's host spans,
        bound to the program's table (or the eager one)."""
        if self.programs is None:
            if tally is not None:
                tally.bind(trace.EAGER_SPANS)
            return fn(*inputs, **static)
        return self.programs.run(name, fn, inputs, self.model, static,
                                 tally=tally)

    def _modes(self) -> dict:
        """The decode modes the window's forward is called with: none for
        a forward that does not take them, which raises if one is set."""
        if self._takes_modes:
            return {"test": self.test_mode,
                    "local_ensemble": self.local_ensemble}
        if self.test_mode or self.local_ensemble:
            raise ValueError(
                f"{type(self.model).__name__}'s forward takes no test= or "
                "local_ensemble=: build the pipeline without test_mode and "
                "local_ensemble")
        return {}

    def _device_scope(self):
        return (torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext())

    def stage(self, frames: np.ndarray, times: Sequence[float]):
        """Pad ``frames`` and put them and ``times`` on the device: a
        window for ``stream``, (x (1, N, Hp, Wp, 3), times (nt,), (h, w)
        before padding, the window's ``trace.Tally``). On a CUDA device the
        inputs go up from pinned memory without a wait, so that staging a
        window does not first wait for the previous one's compute to
        end."""
        tally = trace.Tally()
        with trace.span("stage.pad", into=tally):
            x, (h, w) = pad_to_multiple(np.asarray(frames, np.float32), 4,
                                        self.bucket)
        with trace.span("stage.upload", into=tally):
            xt, t = self._upload(x[None], np.asarray(times, np.float32))
        return xt, t, (h, w), tally

    def _upload(self, *arrays):
        """numpy arrays as tensors on the device: on a CUDA device from
        pinned memory, queued without a wait."""
        with torch.inference_mode(), self._device_scope():
            ts = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
            if self.device.type == "cuda":
                return tuple(v.pin_memory().to(self.device, non_blocking=True)
                             for v in ts)
            return tuple(v.to(self.device) for v in ts)

    def _launch_staged(self, xt: torch.Tensor, t: torch.Tensor, hw,
                       tally: Optional[trace.Tally] = None):
        """Queue the compute of a window ``stage`` put on the device and
        the start of its copy to the host. On a CUDA device the copy runs
        on a side stream that waits for an event recorded when the compute
        ends, into pinned host memory, so that the next window's compute
        (queued on the compute stream meanwhile) overlaps it. The events
        and streams are those of ``self.device``, whichever card is
        current. The frames are first copied, on the compute stream, into a
        tensor of the window's own: a compiled program's next replay writes
        over its output while the side stream may still read this window's,
        and ``record_stream`` does not cover a graph's memory."""
        hp, wp = xt.shape[2], xt.shape[3]
        cuda = self.device.type == "cuda"
        tally = tally if tally is not None else trace.Tally()
        with torch.inference_mode(), self._device_scope():
            out = self._run("window", self.model, (xt, t), tally,
                            out_size=(hp * self.scale, wp * self.scale),
                            **self._modes())
            out = out[:, 0].clone()
            if not cuda:
                return out, None, hw, tally
            computed = torch.cuda.Event()
            computed.record()
            side = self._copy_stream()
            side.wait_event(computed)
            with torch.cuda.stream(side):
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record()
            # the caching allocator must not hand ``out``'s memory to the
            # next window while the side stream still reads it
            out.record_stream(side)
        return host, copied, hw, tally

    def _fetch(self, pending) -> np.ndarray:
        """Wait for a launched window's copy; (nt, H*scale, W*scale, 3)
        numpy in memory of its own. A copy off the pinned buffer: page-locked
        memory is scarce, and the allocator reuses the buffer for a later
        window once this one is dropped. Commits the window's host spans."""
        out, copied, (h, w), tally = pending
        frames = out.numpy()[:, :h * self.scale, :w * self.scale]
        if copied is not None:
            with trace.span("fetch.wait", into=tally):
                copied.synchronize()
            with trace.span("fetch.copy", into=tally):
                frames = frames.copy()
        tally.commit()
        return frames

    def _copy_stream(self):
        if getattr(self, "_side", None) is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    def _render_window_ensemble(self, frames: np.ndarray,
                                times: Sequence[float]) -> np.ndarray:
        """Average over the 8 dihedral transforms (flips + transpose)."""
        acc = None
        for k in range(8):
            f = frames
            if k & 1:
                f = f[:, :, ::-1]
            if k & 2:
                f = f[:, ::-1]
            if k & 4:
                f = np.transpose(f, (0, 2, 1, 3))
            o = self._render_window_raw(np.ascontiguousarray(f), times)
            if k & 4:
                o = np.transpose(o, (0, 2, 1, 3))
            if k & 2:
                o = o[:, ::-1]
            if k & 1:
                o = o[:, :, ::-1]
            acc = o if acc is None else acc + o
        return acc / 8.0

    def render_window_tmnet(self, frames: np.ndarray,
                            times: Sequence[float]) -> np.ndarray:
        """TMNet window render: frames (N, H, W, 3), the times enter as the
        (1, t_N) modulation; the output is the fixed-x4 interleaved sequence
        (N + (N-1) * t_N, 4H, 4W, 3). The copy to the host follows a wait
        for the compute (``fetch.wait``), the same wait the copy from
        pageable memory would make."""
        tally = trace.Tally()
        with trace.span("stage.pad", into=tally):
            x, (h, w) = pad_to_multiple(np.asarray(frames, np.float32), 4,
                                        self.bucket)
        with trace.span("stage.upload", into=tally):
            xt, t = self._upload(x[None],
                                 np.asarray(times, np.float32)[None])
        with torch.inference_mode():
            out = self._run("tmnet", self.model, (xt, t), tally)
            out = out[0, :, :h * 4, :w * 4]
            if self.device.type == "cuda":
                with trace.span("fetch.wait", into=tally):
                    torch.cuda.current_stream(self.device).synchronize()
            with trace.span("fetch.copy", into=tally):
                frames = out.cpu().numpy()
        tally.commit()
        return frames

    def render_pairs(self, pairs: np.ndarray, times: Sequence[float],
                     chunk_size: int = 65536) -> np.ndarray:
        """Batched-pair decode: (B, 2, H, W, 3) distinct LR pairs ->
        (B, nt, H*scale, W*scale, 3).

        The encoder runs once at batch B; the decoder goes through the
        ``ChunkedDecoder``, so the B * nt query set stays memory-bounded at
        any frame size. Neither ensemble applies here, as in the JAX package.
        When compiled, ``gen_feat`` runs as its bucket's program and the
        decoder's passes as its own programs, the decoder's first pass
        copying ``gen_feat``'s output before the pipeline replays anything
        else. The pipeline keeps its decoder, with the decoder's programs
        and buffers, across calls, and makes a new one only when
        ``chunk_size`` changes (``stif_tpu/runtime/pipeline.py:190-192``).
        One blocking call per call: the frames to the host."""
        from stif_tpu_torch.runtime.chunked import ChunkedDecoder

        x, (h, w) = pad_to_multiple(np.asarray(pairs, np.float32), 4,
                                    self.bucket)
        hp, wp = x.shape[2], x.shape[3]
        xt, t = self._upload(x, np.asarray(times, np.float32))
        with torch.inference_mode():
            feat = self._run("gen_feat", self.model.gen_feat, (xt,))
        if self._chunked is None or self._chunked.chunk != chunk_size:
            self._chunked = ChunkedDecoder(
                self.model, chunk_size, device=self.device,
                compiled=(False if self.programs is None
                          else self.programs.sibling()))
        out = self._chunked.decode(feat, xt, t,
                                   (hp * self.scale, wp * self.scale),
                                   hr_inp_upsample=self.test_mode)
        out = np.moveaxis(out, 0, 1)  # (B, nt, HH, WW, 3)
        return out[:, :, :h * self.scale, :w * self.scale]

    def stream(self, staged: Iterable,
               around_launch: Optional[Callable[[], ContextManager]] = None
               ) -> Iterator[np.ndarray]:
        """Render ``stage``d windows in order, double-buffered: window i + 1
        is launched before window i is fetched, so that window i's copy to
        the host overlaps window i + 1's compute. Yields (nt, H*scale,
        W*scale, 3) per window; ``staged`` is read lazily, one window ahead
        of the fetch. ``around_launch``, when given, makes a context
        manager that is entered around each window's launch (CUDA events
        that bracket its compute, say)."""
        def launch(window):
            with (around_launch() if around_launch is not None
                  else contextlib.nullcontext()):
                return self._launch_staged(*window)

        pending = None
        for window in staged:
            nxt = launch(window)
            if pending is not None:
                yield self._fetch(pending)
            pending = nxt
        if pending is not None:
            yield self._fetch(pending)

    def render_sequence(self, frames: np.ndarray,
                        n_times: int = 8) -> List[np.ndarray]:
        """Stream a sequence (T, H, W, 3) through overlapping frame pairs,
        ``n_times`` frames per pair at times i / n_times. Returns a list of
        (n_times, H*scale, W*scale, 3). Double-buffered (``stream``), each
        pair staged just before its launch; the frames equal those of
        ``render_window`` pair by pair, bitwise."""
        if frames.shape[0] < 2:
            raise ValueError("render_sequence needs at least two frames")
        times = [i / n_times for i in range(n_times)]
        return list(self.stream(self.stage(frames[i:i + 2], times)
                                for i in range(frames.shape[0] - 1)))
