"""Per-bucket compiled programs: the counterpart of the JAX pipeline's
``_cache`` of ``jax.jit`` programs (``stif_tpu/runtime/pipeline.py:95-109``
per (shape, nt, out_size), ``:164-168`` for TMNet, ``:185-189`` for
``gen_feat``).

A JAX window is one dispatch of one compiled program. Here a ``Program`` is
one captured ``torch.cuda.CUDAGraph`` of a callable at one input shape. The
``ChunkedDecoder``'s passes are programs too (``runtime/chunked.py``, the
counterpart of ``stif_tpu/runtime/chunked.py:68-87``), and so is the train
step with its EMA (``train/trainer.py:make_train_step``, the counterpart of
``stif_tpu/train/video_sr_model.py:105, 113``). The
first call of a key runs the callable eagerly once: that warm-up builds the
bucket's constants (``ops/constants.py``), the cuDNN and cuBLAS handles and
workspaces and the kernels' shared-memory attributes. The call then captures
the callable on the cache's capture stream, instantiates the graph and
replays it, so its output is bit for bit that of every later replay. A later
call copies its inputs into the program's static inputs on the current
stream and replays the graph: one ``cudaGraphLaunch`` in place of the
forward's ~2,800 launches from Python. A caller may mark inputs
``resident``: they are not copied, the graph reads them where they lie (a
chunk pass reads the whole HR feature field, 4 GiB at 1080p with 8 times,
which a copy per chunk would move again and again).

The key is the JAX key and the model's route:

- the callable's name, the model, every input's shape and dtype, the
  ``data_ptr``, shape, strides and dtype of every resident input, and the
  static arguments (``out_size``, ``test``, ``local_ensemble``). A resident
  tensor at a new address is a new key: a graph never replays over memory
  its caller has let go of;
- the ``data_ptr`` of every tensor of the callable's ``state``: what a
  train step updates in place (parameters, gradients, optimizer state,
  EMA). The key's first call puts the state back after the warm-up and
  after the capture, so that the call makes one update, the replay's;
- the route: the ``data_ptr``, shape and dtype of every parameter and
  buffer of the model, each switched module's flags and the process-wide
  DCN defaults with their epochs (``ops/capture.py``). A graph holds the
  kernels and pointers of its capture: a ``set_fused``, ``set_dcn_kernel``
  or ``set_dcn_impl`` that changes a flag, and a model moved with ``to()``
  (new pointers), make a new key (and the stale programs are dropped); a
  switch and its reverse with no call between leave the key as it was.
  Weights loaded in place (``load_state_dict``, ``copy_``, an optimizer
  step) keep their addresses: the next replay reads the new values, with
  no new capture.

What a program keeps, and what its caller must keep to:

- its static inputs and outputs (a tensor, or a tuple of tensors), the
  store tensors its forward read (the store's bound must not free them),
  and the kernel launches it holds, which each replay adds to the wrappers'
  counts (a capture adds none). It holds no resident input: the caller
  keeps each alive, unchanged in place, for as long as it replays the
  program with it;
- each output is overwritten by the next replay of any program of the same
  cache: its programs share one memory pool (``torch.cuda.graph_pool_handle``),
  so one bucket's output may lie where another's intermediates go. A caller
  reads or copies the outputs on the current stream before it replays
  another program, and replays only on that one stream;
- capture and replay run under ``torch.cuda.device(cache.device)``.

The capture runs in ``thread_local`` capture-error mode: a call that is
illegal during a capture (a host sync, a ``cudaMalloc`` outside the pool)
made by the capturing thread fails the capture, as ``global`` would, but
other threads (a loader pinning its batches, another pipeline's copies) may
go on. ``relaxed`` would let the capturing thread itself sync unseen.

What a program counts (``stats``): its replays and the launches they add;
the device time of each stage its replays marked (``utils/trace.py``: the
marks are kernels inside the graph, writing into a table the program owns,
zeroed after the capture); the host spans of the calls that replayed it
(``launch.copy_in``, ``launch.replay``, and what its caller tallied for the
window or step: staging, fetching), the first call's left out; and the node
count of its graph, read once at the capture.

A capture or a replay that fails raises; nothing falls back to the eager
callable. The CPU has no graphs: ``program_cache`` gives None there unless a
caller hands over a cache of its own with another capture step (the CPU
tests replay the callable into its static outputs, as a graph does).
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from stif_tpu_torch.ops import capture as capture_scope
from stif_tpu_torch.ops.deform_conv import dcn_route
from stif_tpu_torch.utils import trace

CAPTURE_ERROR_MODE = "thread_local"

# one capture stream per card, shared by every cache: PyTorch keeps a cuBLAS
# workspace for each stream it sees, for the life of the process, so a
# stream per pipeline would leave one behind with every pipeline
_capture_streams: Dict[int, torch.cuda.Stream] = {}

# what a program returns: one tensor, or a tuple of them
Outputs = Union[torch.Tensor, Tuple[torch.Tensor, ...]]

# a capture step: (callable, its inputs, cache) -> (replay, static outputs)
CaptureStep = Callable[[Callable, Tuple[torch.Tensor, ...], "ProgramCache"],
                       Tuple[Callable[[], None], Outputs]]


def route(model: torch.nn.Module) -> tuple:
    """What a graph of ``model``'s forward reads by address or was built
    for: every parameter's and buffer's pointer, shape and dtype, each
    switched module's flags and the process-wide DCN defaults, with their
    epochs (``ops/capture.py``). One walk over the modules."""
    flags, tensors = [], []
    for m in model.modules():
        if isinstance(m, capture_scope.Switched):
            flags.append(capture_scope.route_of(m))
        tensors += m._parameters.values()
        tensors += m._buffers.values()
    return (dcn_route(), tuple(flags),
            tuple((v.data_ptr(), tuple(v.shape), v.dtype) for v in tensors
                  if v is not None))


@contextlib.contextmanager
def _collector_paused():
    """Collect the garbage now and keep the cyclic collector off inside. A
    reference cycle that holds an older program (its graph) could otherwise
    be collected in the middle of a capture, and destroying a graph there
    invalidates the capture (``torch.cuda.graph`` no longer collects before
    it captures)."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def cuda_graph(fn: Callable, inputs: Tuple[torch.Tensor, ...],
               cache: "ProgramCache"):
    """The capture step on a CUDA device: ``fn(*inputs)`` captured into a
    ``torch.cuda.CUDAGraph`` on the cache's capture stream, in its pool
    (``inputs`` are the static inputs, then the resident ones). Where
    PyTorch keeps the captured graph (``keep_graph``), its node count goes
    to the capture's recording before the graph is instantiated."""
    try:
        graph, kept = torch.cuda.CUDAGraph(keep_graph=True), True
    except TypeError:  # a PyTorch without keep_graph
        graph, kept = torch.cuda.CUDAGraph(), False
    with torch.cuda.graph(graph, pool=cache.pool, stream=cache.stream,
                          capture_error_mode=CAPTURE_ERROR_MODE):
        out = fn(*inputs)
    if kept:
        capture_scope.current().graph_nodes = trace.graph_nodes(
            graph.raw_cuda_graph())
        graph.instantiate()
    return graph.replay, out


class Program:
    """One captured callable at one key (see the module docstring)."""

    def __init__(self, label: str, inputs: Tuple[torch.Tensor, ...],
                 output: Outputs, replay: Callable[[], None],
                 recording: capture_scope.Recording, warmup_ms: float,
                 capture_ms: float, pool_bytes: Optional[int]):
        self.label = label
        self.inputs = inputs
        self.output = output
        self._replay = replay
        self.held = list(recording.tensors.values())
        self.launches = recording.launches
        self.counters = recording.counters
        self.warmup_ms = warmup_ms
        self.capture_ms = capture_ms
        self.pool_bytes = pool_bytes
        self.replays = 0
        self.marks = recording.marks
        self.host = trace.Spans()
        self.graph_nodes = recording.graph_nodes

    def __call__(self, *args: torch.Tensor,
                 tally: Optional[trace.Tally] = None) -> Outputs:
        """Copy ``args`` into the static inputs, replay, count the launches;
        the static outputs (overwritten by the next replay of the cache).
        The resident inputs are read where they were at the capture. The
        two steps are host spans of ``tally``."""
        with trace.span("launch.copy_in", into=tally):
            for static, arg in zip(self.inputs, args):
                static.copy_(arg)
        with trace.span("launch.replay", into=tally), \
                trace.into_marks(self.marks):
            self._replay()
        self.replays += 1
        for wrapper, n in self.launches.items():
            wrapper.launches += n
        for (wrapper, name), n in self.counters.items():
            capture_scope.add_counters(wrapper, {name: n})
        return self.output

    def stats(self) -> dict:
        """The program's line; ``stages`` is read off the card by one small
        copy (see the module docstring)."""
        return {"key": self.label, "replays": self.replays,
                "warmup_ms": round(self.warmup_ms, 3),
                "capture_ms": round(self.capture_ms, 3),
                "pool_bytes": self.pool_bytes,
                "held_constants": len(self.held),
                "launches": {w.__name__: n
                             for w, n in self.launches.items()},
                "graph_nodes": self.graph_nodes,
                "stages": self.marks.read(), "host": self.host.read()}


class ProgramCache:
    """The programs of one pipeline on one device, keyed as the module
    docstring says, sharing one memory pool and one capture stream.
    ``capture`` is the capture step; ``cuda_graph`` by default, which needs
    a CUDA device."""

    def __init__(self, device, capture: Optional[CaptureStep] = None):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if capture is None:
            if not self.cuda:
                raise ValueError(f"CUDA graphs need a CUDA device, not "
                                 f"{self.device}; run eagerly there")
            capture = cuda_graph
        self.capture = capture
        self.programs: Dict[tuple, Program] = {}
        self.captures = 0
        self._pool = None

    @property
    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    @property
    def stream(self) -> Optional[torch.cuda.Stream]:
        """The capture stream of this cache's card (None on the CPU)."""
        if not self.cuda:
            return None
        index = (self.device.index if self.device.index is not None
                 else torch.cuda.current_device())
        if index not in _capture_streams:
            _capture_streams[index] = torch.cuda.Stream(index)
        return _capture_streams[index]

    def _scope(self):
        return (torch.cuda.device(self.device) if self.cuda
                else contextlib.nullcontext())

    def run(self, name: str, fn: Callable, inputs: Sequence[torch.Tensor],
            model: torch.nn.Module, static: Optional[dict] = None,
            resident: Sequence[torch.Tensor] = (),
            state: Sequence[torch.Tensor] = (),
            tally: Optional[trace.Tally] = None) -> Outputs:
        """``fn(*inputs, *resident, **static)``, through the program of its
        key: a replay, or on the key's first call a warm-up, a capture and
        a replay. ``inputs`` are copied into the program's static inputs at
        each call, ``resident`` ones are read in place (see the module
        docstring). ``state`` are the tensors ``fn`` updates in place (a
        train step's parameters, gradients, optimizer state and EMA): their
        addresses enter the key, and a key's first call leaves their values
        as they were before its warm-up and capture, so that its replay
        makes the one update of the call. ``tally``: the host spans of the
        caller's window or step, bound here to the program's table when the
        program existed before the call (else to none: a first call's
        warm-up and capture are not counted); without one the call's own
        spans are committed here. Returns the program's static outputs
        (read or copy them before the next call of this cache)."""
        static = dict(static or {})
        resident = tuple(resident)
        key = (name, model,
               tuple((tuple(v.shape), v.dtype) for v in inputs),
               tuple((v.data_ptr(), tuple(v.shape), v.stride(), v.dtype)
                     for v in resident),
               tuple(v.data_ptr() for v in state),
               tuple(sorted(static.items())), route(model))
        own = tally is None
        if own:
            tally = trace.Tally()
        with self._scope():
            program = self.programs.get(key)
            tally.bind(None if program is None else program.host)
            if program is None:
                self._drop_stale()
                label = (f"{name} {[tuple(v.shape) for v in inputs]}"
                         + "".join(f" {k}={v}" for k, v in sorted(
                             static.items())))
                program = self._compile(
                    label, lambda *xs: fn(*xs, **static), tuple(inputs),
                    resident, tuple(state))
                self.programs[key] = program
            out = program(*inputs, tally=tally)
        if own:
            tally.commit()
        return out

    def _drop_stale(self) -> None:
        """Forget the programs whose model's route changed since their
        capture: no key can reach them again."""
        for key in [k for k in self.programs if k[-1] != route(k[1])]:
            del self.programs[key]

    def clear(self) -> None:
        """Forget every program: their graphs and static buffers go, the
        pool stays for the next captures."""
        self.programs.clear()

    def sibling(self) -> "ProgramCache":
        """An empty cache on the same device with the same capture step and
        a pool of its own: no replay of one can write over the other's
        outputs."""
        return ProgramCache(self.device, self.capture)

    def _compile(self, label: str, fn: Callable,
                 inputs: Tuple[torch.Tensor, ...],
                 resident: Tuple[torch.Tensor, ...] = (),
                 state: Tuple[torch.Tensor, ...] = ()) -> Program:
        statics = tuple(torch.empty_like(v) for v in inputs)
        for s, v in zip(statics, inputs):
            s.copy_(v)
        args = statics + resident
        # detached: a clone of a parameter would keep its AccumulateGrad
        # node alive, made on this stream, and the capture's backward would
        # then wait on this stream, which is not part of the capture
        saved = [v.detach().clone() for v in state]

        def restore():
            with torch.no_grad():
                torch._foreach_copy_(list(state), saved)

        # the table the program's marks write: the warm-up's and the
        # capture's marks land there too, and are zeroed after
        marks = trace.Marks(self.device)
        with _collector_paused(), trace.into_marks(marks):
            t0 = time.perf_counter()
            if self.cuda:
                # the warm-up on the capture stream: the workspaces it makes
                # are those of the stream the capture runs on
                self.stream.wait_stream(
                    torch.cuda.current_stream(self.device))
                with torch.cuda.stream(self.stream):
                    fn(*args)
                torch.cuda.synchronize(self.device)
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved(self.device)
            else:
                fn(*args)
            if state:
                restore()
            t1 = time.perf_counter()
            with capture_scope.scope(self.stream) as recording:
                recording.marks = marks
                replay, output = self.capture(fn, args, self)
            if state:  # a capture step that runs ``fn`` (the CPU's double)
                restore()
        marks.zero()
        outputs = output if isinstance(output, tuple) else (output,)
        if not outputs or not all(isinstance(v, torch.Tensor)
                                  for v in outputs):
            raise TypeError(f"a compiled program returns a tensor or a tuple "
                            f"of tensors, got {type(output).__name__}")
        t2 = time.perf_counter()
        pool_bytes = (torch.cuda.memory_reserved(self.device) - reserved
                      if self.cuda else None)
        self.captures += 1
        return Program(label, statics, output, replay, recording,
                       1e3 * (t1 - t0), 1e3 * (t2 - t1), pool_bytes)

    def stats(self) -> List[dict]:
        """One line per live program: its key, replays, the first call's
        warm-up and capture ms, the pool bytes its capture added, the store
        tensors it holds, its launches per replay, its graph's node count
        and its ``stages`` and ``host`` tables."""
        return [p.stats() for p in self.programs.values()]


def program_cache(device, compiled=None) -> Optional[ProgramCache]:
    """The program cache of a pipeline on ``device``: ``compiled`` None
    gives graphs on a CUDA device and None (eager) on another, False None,
    True a cache (ValueError off a CUDA device), and a ``ProgramCache``
    itself."""
    if isinstance(compiled, ProgramCache):
        return compiled
    dev = torch.device(device)
    if compiled is None:
        compiled = dev.type == "cuda"
    if not compiled:
        return None
    return ProgramCache(dev)
