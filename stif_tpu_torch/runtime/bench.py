"""The headline throughput workload of the port (counterpart of the JAX
package's ``bench.py``): LR frame pairs streamed through the deployed
``LunaTokis`` (nf 64, 5 + 40 residual blocks, ``rgb_skip`` bicubic) into 8
frames at x4, and the frames/s a user buys.

Two streaming modes, the faster one the headline:

* ``bench_b1``: batch 1, double-buffered. The pairs are staged on the device
  before the clock; each window is the model, then clamp, round and
  ``uint8`` on the device (``Quantized``); ``InferencePipeline.stream``
  launches pair i + 1 before it fetches pair i, through the pipeline's
  pinned buffer on a side stream, so that the copy overlaps the next
  window's compute. Wall clock by ``perf_counter`` around the stream; each
  window's device span by CUDA events around its launch.
* ``bench_batched``: ``pair_batch`` pairs per call, the encoder at that
  batch, the decoder as one full decode (``full``), two decodes of half
  the times each (``tsplit``, the JAX bench's mode for a TPU compile limit,
  kept with the same semantics), or the ``ChunkedDecoder`` at a chunk size.

The knobs are read from the same ``BENCH_*`` variables as the JAX bench
(``Knobs.from_env``). Three defaults differ on purpose: gathers, the SIREN
nets and ``encode_imnet`` run fp32 and unsplit, because ``mlp_dtype`` and
``encode_splitk`` take every SIREN net off the fused kernel; the JAX
defaults stay one setting away (``BENCH_GATHER_DTYPE=bf16
BENCH_MLP_DTYPE=bf16 BENCH_ENCODE_SPLITK=1``) and the record names the mode
that ran. TF32 is off for cuDNN convs and matmuls (``build``).

``window_flops`` counts a window's operations from the module shapes, as
``torch.utils.flop_counter.FlopCounterMode`` counts them on the plain path;
``record`` builds the one JSON line of ``scripts/bench_torch.py``.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from stif_tpu_torch.runtime.pipeline import InferencePipeline

ROOT = Path(__file__).resolve().parents[2]
WEIGHTS = ROOT / "weights" / "trained_best_G.pth"
BASELINE = ROOT / "BASELINE_MEASURED.json"

# the JAX bench's workload (bench.py:27-30)
LR_H, LR_W = 96, 160
N_TIMES = 8
WARMUP = 2
ITERS = 5
SCALE = 4
DEPLOYED = dict(nf=64, groups=8, front_RBs=5, back_RBs=40)

# published dense fp32 peaks outside the tensor cores (NVIDIA data sheets):
# the denominator of ``mfu``; the window runs fp32 (TF32 off)
FP32_PEAKS = {"H100 SXM": 67e12, "H100 PCIe": 51e12}
# the cards of that table by the name ``torch.cuda.get_device_name`` gives
CARDS = {"NVIDIA H100 80GB HBM3": "H100 SXM", "NVIDIA H100 PCIe": "H100 PCIe"}


def _flag(value: str) -> bool:
    return value not in ("0", "false", "")


@dataclass(frozen=True)
class Knobs:
    """The model's knobs and the batched mode, as the JAX bench reads them
    from ``BENCH_*`` variables (``bench.py:37, 64-96, 194``)."""

    gather_dtype: str = "fp32"
    mlp_dtype: str = "fp32"
    encode_splitk: bool = False
    stagec_dedup: bool = False
    stagec_nearest: bool = False
    stagec_dtype: Optional[str] = None
    rgb_skip: str = "bicubic"
    dcn_impl: Optional[str] = None
    shift_bound: Optional[int] = None
    pair_batch: int = 2
    chunk: str = "full"

    @classmethod
    def from_env(cls, env=None) -> "Knobs":
        env = os.environ if env is None else env
        bound = env.get("BENCH_SHIFT_BOUND")
        return cls(
            gather_dtype=env.get("BENCH_GATHER_DTYPE", "fp32"),
            mlp_dtype=env.get("BENCH_MLP_DTYPE", "fp32"),
            encode_splitk=_flag(env.get("BENCH_ENCODE_SPLITK", "0")),
            stagec_dedup=_flag(env.get("BENCH_STAGEC_DEDUP", "0")),
            stagec_nearest=_flag(env.get("BENCH_STAGEC_NEAREST", "0")),
            stagec_dtype=env.get("BENCH_STAGEC_DTYPE") or None,
            rgb_skip=env.get("BENCH_RGB_SKIP", "bicubic"),
            dcn_impl=env.get("BENCH_DCN_IMPL") or None,
            shift_bound=int(bound) if bound else None,
            pair_batch=int(env.get("BENCH_PAIR_BATCH", "2")),
            chunk=env.get("BENCH_CHUNK", "full"))


def build(device, weights=WEIGHTS, knobs: Knobs = Knobs(), **arch):
    """The deployed ``LunaTokis`` under ``knobs`` on ``device``, in eval
    mode. ``weights``: a reference-schema ``.pth`` loaded strictly (the
    trained weights by default: their DCN offsets are the deployed ones), or
    None for the seeded init of ``nn/init.py`` (seed 0; every DCN offset
    zero). ``arch`` overrides the deployed widths (nf, groups, front_RBs,
    back_RBs). Turns TF32 off, and applies ``dcn_impl`` / ``shift_bound``
    through ``set_dcn_impl``, as the JAX bench does."""
    from stif_tpu_torch.convert import load_pth
    from stif_tpu_torch.models.factory import define_g
    from stif_tpu_torch.nn.init import init_model_
    from stif_tpu_torch.ops.deform_conv import set_dcn_impl

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if knobs.dcn_impl:
        set_dcn_impl(knobs.dcn_impl, knobs.shift_bound)
    net = dict(which_model_G="LIIF", **{**DEPLOYED, **arch},
               gather_dtype=knobs.gather_dtype, mlp_dtype=knobs.mlp_dtype,
               encode_splitk=knobs.encode_splitk,
               stagec_dedup=knobs.stagec_dedup,
               stagec_nearest=knobs.stagec_nearest,
               stagec_dtype=knobs.stagec_dtype,
               rgb_skip=(None if knobs.rgb_skip in ("none", "0", "false")
                         else knobs.rgb_skip))
    model = define_g({"network_G": net})
    if weights is None:
        init_model_(model, torch.Generator().manual_seed(0))
    else:
        load_pth(model, str(weights))
    return model.to(device).eval()


def quantize(out: torch.Tensor) -> torch.Tensor:
    """Frames as the product saves them: clamp to [0, 1], scale to 255,
    round half to even, ``uint8`` (``bench.py:126-130``)."""
    return torch.round(out.clamp(0, 1) * 255).to(torch.uint8)


class Quantized(torch.nn.Module):
    """A model whose output is ``quantize``d on its device: the window the
    b1 mode streams through ``InferencePipeline``."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *args, **kwargs) -> torch.Tensor:
        return quantize(self.model(*args, **kwargs))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counts():
    from stif_tpu_torch.ops import dcn_forward, siren_apply_fused

    return siren_apply_fused.launches, dcn_forward.launches


def _peak_reset(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak_gib(device) -> Optional[float]:
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def times_for(nt: int) -> List[float]:
    return [i / nt for i in range(nt)]


def draw_pairs(rng: np.random.Generator, n: int, lr_hw,
               batch: int = 1) -> np.ndarray:
    """``n`` groups of ``batch`` LR pairs, uniform in [0, 1), as the JAX
    bench draws them: (n, batch, 2, H, W, 3) float32."""
    return rng.random((n, batch, 2) + tuple(lr_hw) + (3,)).astype(np.float32)


def bench_b1(model, pairs: np.ndarray, times: Sequence[float],
             warmup: int = WARMUP) -> dict:
    """Stream ``pairs`` (n, 2, H, W, 3) at batch 1, double-buffered, after
    ``warmup`` windows of the first pair. Returns ``fps``, ``window_s``
    (wall per window), ``window_device_ms`` (each window's span on the
    compute stream by CUDA events; None on the CPU), ``outs`` (the uint8
    frames of each pair, (nt, 4H, 4W, 3)), ``siren_launches`` and
    ``dcn_launches`` per window, and ``peak_gib``."""
    device = next(model.parameters()).device
    # bucket 1: the pair is padded only to the model's multiple of 4
    pipe = InferencePipeline(Quantized(model), scale=SCALE, bucket=1,
                             device=device)
    cuda = device.type == "cuda"
    staged = [pipe.stage(p, times) for p in pairs]
    _peak_reset(device)
    n0 = _counts()
    for _ in range(warmup):
        list(pipe.stream(staged[:1]))
    events = []

    @contextlib.contextmanager
    def timed():
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        yield
        end.record()
        events.append((start, end))

    _sync(device)
    t0 = time.perf_counter()
    outs = list(pipe.stream(staged, timed if cuda else None))
    window_s = (time.perf_counter() - t0) / len(staged)
    n1 = _counts()
    windows = warmup + len(staged)
    return {
        "fps": len(times) / window_s,
        "window_s": window_s,
        "window_device_ms": ([a.elapsed_time(b) for a, b in events]
                             if cuda else None),
        "outs": outs,
        "siren_launches": (n1[0] - n0[0]) / windows,
        "dcn_launches": (n1[1] - n0[1]) / windows,
        "peak_gib": _peak_gib(device),
    }


def stage_split(model, pair: np.ndarray, times: Sequence[float]) -> dict:
    """Diagnostic split of one window into separate, synchronised calls
    (``bench.py:156-182``): ``encode_s`` (``gen_feat``), ``decode_s`` (the
    decode and its quantisation) and ``transfer_s`` (the full uint8 frames
    to the host), each the mean of two runs after a warm-up."""
    device = next(model.parameters()).device
    x = torch.from_numpy(pair[None]).to(device)
    t = torch.tensor(list(times), dtype=torch.float32, device=device)

    def mean_s(fn):
        fn()
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(2):
            out = fn()
            _sync(device)
        return (time.perf_counter() - t0) / 2, out

    with torch.inference_mode():
        enc, feat = mean_s(lambda: model.gen_feat(x))
        dec, frames = mean_s(lambda: quantize(model.decode(feat, x, t)))
        t0 = time.perf_counter()
        frames.cpu()
        xfer = time.perf_counter() - t0
    return {"encode_s": enc, "decode_s": dec, "transfer_s": xfer}


def bench_batched(model, groups: np.ndarray, times: Sequence[float],
                  mode: str = "full", warmup: int = WARMUP) -> dict:
    """Stream ``groups`` (n, B, 2, H, W, 3) of B pairs per call after
    ``warmup`` calls on the first group; ``mode`` is ``full``, ``tsplit``
    or a ``ChunkedDecoder`` chunk size. The groups are staged on the device
    before the clock; the clock stops when the device has finished the last
    group (``bench.py:187-259``). Returns ``fps``, ``outs`` (uint8 (nt, B,
    4H, 4W, 3) per group, on the host) and ``peak_gib``."""
    from stif_tpu_torch.runtime.chunked import ChunkedDecoder

    device = next(model.parameters()).device
    t = torch.tensor(list(times), dtype=torch.float32, device=device)
    hh, ww = groups.shape[3] * SCALE, groups.shape[4] * SCALE
    half = len(times) // 2
    if mode == "full":
        def run(xb):
            return quantize(model(xb, t))
    elif mode == "tsplit":
        def run(xb):
            feat = model.gen_feat(xb)
            return torch.cat([quantize(model.decode(feat, xb, t[:half])),
                              quantize(model.decode(feat, xb, t[half:]))])
    else:
        decoder = ChunkedDecoder(model, chunk_size=int(mode), device=device)

        def run(xb):
            out = decoder.decode(model.gen_feat(xb), xb, t, (hh, ww))
            return quantize(torch.from_numpy(out))

    with torch.inference_mode():
        staged = [torch.from_numpy(g).to(device) for g in groups]
        _peak_reset(device)
        for _ in range(warmup):
            run(staged[0])
        _sync(device)
        t0 = time.perf_counter()
        outs = [run(xb) for xb in staged]
        _sync(device)
        dt = (time.perf_counter() - t0) / len(staged)
        peak = _peak_gib(device)
        outs = [o.cpu().numpy() for o in outs]
    return {"fps": groups.shape[1] * len(times) / dt, "outs": outs,
            "peak_gib": peak}


# ------------------------------------------------------------------ FLOPs

def _conv(conv, n: int, hw):
    """FLOPs of one ``Conv`` on ``n`` maps of size ``hw``, as
    ``FlopCounterMode`` counts ``aten.convolution`` (2 x output pixels x
    weights; the bias not counted), and its output size."""
    (kh, kw), (sh, sw), (ph, pw) = conv.kernel_size, conv.stride, conv.padding
    ho = (hw[0] + 2 * ph - kh) // sh + 1
    wo = (hw[1] + 2 * pw - kw) // sw + 1
    return 2 * n * ho * wo * conv.weight.numel(), (ho, wo)


def _resize(n: int, in_hw, out_hw, c: int) -> int:
    """FLOPs of a separable resize (``ops/resize.py``): two matrix products,
    (out_h, in_h) over the rows, then (out_w, in_w) over the columns."""
    (h, w), (oh, ow) = in_hw, out_hw
    return 2 * oh * h * n * w * c + 2 * ow * w * n * oh * c


def _dcn(dcn, n: int, hw, parts: dict) -> None:
    """A ``DCNSep``: its offset-and-mask conv, then the contraction of the
    (n*Ho*Wo, K*Cin) columns with the (K*Cin, Cout) weight (one ``addmm``
    on the plain path, the tensor-core product in the kernel)."""
    f, out = _conv(dcn.conv_offset_mask, n, hw)
    parts["convs"] += f
    parts["dcn"] += 2 * n * out[0] * out[1] * dcn.weight.numel()


def _pcd(p, n: int, hws, parts: dict) -> None:
    """A ``PCDAlign`` on pyramids of ``n`` maps at ``hws`` (L1, L2, L3)."""
    for s in ("1", "2"):
        def conv(name, lvl):
            parts["convs"] += _conv(getattr(p, f"{name}_{s}"), n, hws[lvl])[0]

        def up(lvl, c):  # level lvl + 1 -> lvl, bilinear x2
            parts["resize"] += _resize(n, hws[lvl + 1], hws[lvl], c)

        nf = getattr(p, f"L3_offset_conv2_{s}").out_channels
        conv("L3_offset_conv1", 2)
        conv("L3_offset_conv2", 2)
        _dcn(getattr(p, f"L3_dcnpack_{s}"), n, hws[2], parts)
        for lvl, name in ((1, "L2"), (0, "L1")):
            conv(f"{name}_offset_conv1", lvl)
            up(lvl, nf)          # the coarser offsets
            conv(f"{name}_offset_conv2", lvl)
            conv(f"{name}_offset_conv3", lvl)
            _dcn(getattr(p, f"{name}_dcnpack_{s}"), n, hws[lvl], parts)
            up(lvl, nf)          # the coarser aligned features
            conv(f"{name}_fea_conv", lvl)


def flop_parts(model, B: int, nt: int, out_hw, lr_hw=None) -> Dict[str, int]:
    """A window's FLOPs by kind, for ``B`` pairs at LR ``lr_hw`` (default
    ``out_hw`` / 4) decoded at ``nt`` times onto the full ``out_hw`` grid,
    counted from the module shapes as ``FlopCounterMode`` counts the plain
    path of ``LunaTokis.forward``:

    - ``convs``: every ``aten.convolution`` (2 per multiply-add, bias not
      counted): the encoder's convs and each DCN's offset-and-mask conv;
    - ``dcn``: each DCN's contraction (``aten.addmm`` on the plain path);
    - ``resize``: the separable resizes' matrix products (``aten.bmm``): the
      PCD's bilinear x2 upsamples and the bicubic skip source;
    - ``siren``: the three SIREN nets' layers (``aten.mm``), 2 x rows x
      weights with rows = nt x B x out_h x out_w.

    Not counted, as the flop counter does not count them: ``grid_sample``,
    the DCN's bilinear sampling, and every elementwise op (activations,
    sines, bias adds, the gates)."""
    m = model
    H, W = lr_hw if lr_hw is not None else (out_hw[0] // 4, out_hw[1] // 4)
    N = 2
    T = 2 * N - 1
    parts = {"convs": 0, "dcn": 0, "resize": 0, "siren": 0}

    def conv(c, n, hw):
        f, out = _conv(c, n, hw)
        parts["convs"] += f
        return out

    l1 = (H, W)
    conv(m.conv_first, B * N, l1)
    for blk in m.feature_extraction:
        conv(blk.conv1, B * N, l1)
        conv(blk.conv2, B * N, l1)
    l2 = conv(m.fea_L2_conv1, B * N, l1)
    conv(m.fea_L2_conv2, B * N, l2)
    l3 = conv(m.fea_L3_conv1, B * N, l2)
    conv(m.fea_L3_conv2, B * N, l3)
    _pcd(m.pcd_align, B, (l1, l2, l3), parts)
    conv(m.fusion, B, l1)

    fwd = m.ConvBLSTM.forward_net
    for _ in range(T):  # both directions as one batch of 2B
        for e in (fwd.pcd_h, fwd.pcd_c):
            e2 = conv(e.fea_L2_conv1, 4 * B, l1)  # the pair on the batch axis
            conv(e.fea_L2_conv2, 4 * B, e2)
            e3 = conv(e.fea_L3_conv1, 4 * B, e2)
            conv(e.fea_L3_conv2, 4 * B, e3)
            _pcd(e.pcd_align, 2 * B, (l1, e2, e3), parts)
            conv(e.fusion, 2 * B, l1)
        conv(fwd.cell_list[0].conv, 2 * B, l1)
    conv(m.ConvBLSTM.conv_1x1, B * T, l1)
    for blk in m.recon_trunk:
        conv(blk.conv1, B * T, l1)
        conv(blk.conv2, B * T, l1)

    if m.rgb_skip and m.rgb_skip_bicubic:
        parts["resize"] += _resize(B, l1, out_hw, 6)
    rows = nt * B * out_hw[0] * out_hw[1]
    for net in (m.feat_imnet, m.flow_imnet, m.encode_imnet):
        parts["siren"] += 2 * rows * sum(
            lin.weight.numel() for lin in
            [s.linear for s in net.net[:-1]] + [net.net[-1]])
    return parts


def window_flops(model, B: int, nt: int, out_hw, lr_hw=None) -> int:
    """The window's FLOPs (``flop_parts`` summed)."""
    return sum(flop_parts(model, B, nt, out_hw, lr_hw).values())


# ----------------------------------------------------------------- record

def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_model(name: str) -> str:
    """The ``FP32_PEAKS`` entry of the card ``name``; ValueError for a card
    the table does not hold, rather than a guess."""
    if name not in CARDS:
        raise ValueError(f"no fp32 peak is known for {name!r}; known cards: "
                         f"{', '.join(CARDS)}")
    return CARDS[name]


def fp32_peak(device: torch.device):
    """(name, FLOP/s) of the card's fp32 peak; None on the CPU, which has no
    device peak to hold the window against."""
    if device.type != "cuda":
        return None
    key = card_model(torch.cuda.get_device_name(device))
    return key, FP32_PEAKS[key]


def device_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count()}


def _median(runs):
    return float(np.median(runs)) if runs else None


def record(*, device, knobs: Knobs, weights, lr_hw, n_times: int,
           iters: int, b1_runs: List[dict], batched_runs: List[dict],
           stages: dict, flops: int, arch: dict) -> dict:
    """The bench line: every key of ``bench.py``'s line under its name
    (``metric`` ``frames_per_sec``, ``value`` the larger of the b1 and
    batched medians), then the card, the FLOP peak ``mfu`` is held
    against, launches per b1 window, peak memory per mode and the per-run
    values. Device numbers are None on the CPU."""
    from stif_tpu_torch.ops import deform_conv
    from stif_tpu_torch.utils.provenance import stamp

    fps1 = _median([r["fps"] for r in b1_runs])
    fps_b = _median([r["fps"] for r in batched_runs])
    fps = max(fps1, fps_b or 0.0)
    vs = None
    # the baseline timed the deployed workload; another size has none
    if (BASELINE.exists() and tuple(lr_hw) == (LR_H, LR_W)
            and n_times == N_TIMES and arch == DEPLOYED):
        ref = json.loads(BASELINE.read_text()).get("torch_cpu_frames_per_sec")
        if ref:
            vs = fps / ref
    peak = fp32_peak(device)
    window_s = n_times / fps1
    mfu = flops / window_s / peak[1] if peak else None
    cuda = device.type == "cuda"
    device_ms = [ms for r in b1_runs for ms in (r["window_device_ms"] or [])]
    return {
        "metric": "frames_per_sec",
        "provenance": stamp(
            weights=str(weights) if weights else None,
            config=f"runtime/bench.py LR {lr_hw[0]}x{lr_hw[1]} "
                   f"nt={n_times}"),
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(vs, 2) if vs is not None else None,
        "b1_fps": round(fps1, 3),
        "batched_fps": round(fps_b, 3) if fps_b else None,
        "batched_mode": knobs.chunk if batched_runs else None,
        "pair_batch": knobs.pair_batch,
        "mfu": round(mfu, 4) if mfu is not None else None,
        "workload_tflops": round(flops / 1e12, 3),
        "encode_splitk": knobs.encode_splitk,
        "stagec_dedup": knobs.stagec_dedup,
        "stagec_nearest": knobs.stagec_nearest,
        "stagec_dtype": knobs.stagec_dtype,
        "rgb_skip": knobs.rgb_skip,
        "gather_dtype": knobs.gather_dtype,
        "mlp_dtype": knobs.mlp_dtype,
        "dcn_impl": deform_conv._DEFAULT_IMPL,
        "stages": {k: round(v, 4) for k, v in stages.items()},
        "device": device_info(device),
        "card": card_line() if cuda else None,
        "mfu_peak": ({"name": f"{peak[0]} fp32 (CUDA cores)",
                      "flops_per_s": peak[1]} if peak else None),
        "tf32": False,
        "weights": str(weights) if weights else "seeded (nn/init.py, seed 0)",
        "arch": arch,
        "lr_hw": list(lr_hw),
        "n_times": n_times,
        "iters": iters,
        "repeats": len(b1_runs),
        "siren_launches": b1_runs[0]["siren_launches"],
        "dcn_launches": b1_runs[0]["dcn_launches"],
        "peak_gib": {mode: (round(max(r["peak_gib"] for r in runs), 3)
                            if cuda and runs else None)
                     for mode, runs in (("b1", b1_runs),
                                        ("batched", batched_runs))},
        "b1_fps_runs": [round(r["fps"], 3) for r in b1_runs],
        "batched_fps_runs": [round(r["fps"], 3) for r in batched_runs],
        "window_device_ms": ({"median": round(float(np.median(device_ms)), 3),
                              "runs": [round(v, 3) for v in device_ms]}
                             if device_ms else None),
    }


def add_workload_args(ap) -> None:
    """The flags the bench's scripts share: the device, the weights, the
    seed, and the workload's sizes (the deployed ones by default; smaller
    ones are for runs on the CPU)."""
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--weights", default=str(WEIGHTS),
                    help="reference-schema .pth, or 'none' for the seeded "
                         "init (seed 0)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr-h", type=int, default=LR_H)
    ap.add_argument("--lr-w", type=int, default=LR_W)
    ap.add_argument("--n-times", type=int, default=N_TIMES)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--nf", type=int, default=DEPLOYED["nf"])
    ap.add_argument("--front-rbs", type=int, default=DEPLOYED["front_RBs"])
    ap.add_argument("--back-rbs", type=int, default=DEPLOYED["back_RBs"])


def workload_kwargs(args) -> dict:
    """``run``'s keyword arguments from ``add_workload_args``' flags."""
    return dict(weights=None if args.weights == "none" else args.weights,
                lr_hw=(args.lr_h, args.lr_w), n_times=args.n_times,
                iters=args.iters, seed=args.seed,
                arch=dict(nf=args.nf, front_RBs=args.front_rbs,
                          back_RBs=args.back_rbs))


def run(device, knobs: Knobs, weights=WEIGHTS, lr_hw=(LR_H, LR_W),
        n_times: int = N_TIMES, iters: int = ITERS, repeats: int = 3,
        seed: int = 0, arch: Optional[dict] = None) -> dict:
    """The whole bench: build, then ``repeats`` alternations of the b1 and
    batched modes (each with its own warm-up), the stage split once, and
    the record. Raises on any failure; nothing is caught."""
    arch = dict(DEPLOYED, **(arch or {}))
    model = build(device, weights, knobs, **arch)
    rng = np.random.default_rng(seed)
    times = times_for(n_times)
    pairs = draw_pairs(rng, iters, lr_hw)[:, 0]
    groups = draw_pairs(rng, max(2, iters // knobs.pair_batch), lr_hw,
                        knobs.pair_batch)
    b1_runs, batched_runs = [], []
    for _ in range(repeats):
        b1_runs.append(bench_b1(model, pairs, times))
        if knobs.pair_batch > 1:
            batched_runs.append(bench_batched(model, groups, times,
                                              knobs.chunk))
    stages = stage_split(model, pairs[0], times)
    out_hw = (lr_hw[0] * SCALE, lr_hw[1] * SCALE)
    flops = window_flops(model, 1, n_times, out_hw, lr_hw)
    return record(device=device, knobs=knobs, weights=weights, lr_hw=lr_hw,
                  n_times=n_times, iters=iters, b1_runs=b1_runs,
                  batched_runs=batched_runs, stages=stages, flops=flops,
                  arch=arch)

