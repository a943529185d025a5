#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``stif_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. In order:

1. device: the card's name and power limit; TF32 off for cuDNN convs and
   matmuls (fp32 parity with the JAX reference);
2. build: every CUDA kernel of the serving path, from ``stif_tpu_torch/csrc``,
   one ``nvcc`` per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the decoder's three nets with their real field splits (max|d| <= 1e-4):
   contiguous fields, then the decoder's real layouts (column slices of a
   198-wide tensor, fields broadcast over the time axis, ragged row
   counts), and the kernel's sine against a float64 sine; then timed at the main path's shapes (LR 96x160, 8 times, x4);
4. main path: the deployed full-width model (``rgb_skip`` bicubic) with the
   trained weights ``weights/trained_best_G.pth`` through
   ``InferencePipeline.render_window`` on a seeded 96x160 LR pair at 8 times:
   shape and finiteness, kernel launches per window, the same window with
   the plain SIREN (max|d| <= 1e-3), a small window against the port on the
   CPU (max|d| <= 1e-3), timings, and one window's device time by kernel;
5. the ``kernels`` JSON line, then the result line.

Any failed check raises and the script exits non-zero; without a CUDA
device it exits 2 and prints no result. ``python3 chip_smoke.py --kernels``
stops after phase 3 and prints no result line (for work on a kernel).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WEIGHTS = ROOT / "weights" / "trained_best_G.pth"
LR_HW = (96, 160)
N_TIMES = 8
SCALE = 4
KERNEL_BAR = 1e-4   # kernel vs plain, one net
SINE_BAR = 5e-7     # the kernel's sine vs a float64 sine (sinf: 2 ulp)
WINDOW_BAR = 1e-3   # whole window, kernel vs plain SIREN / GPU vs CPU
# the decoder's three nets: field splits and layer widths (input first)
NETS = {
    "feat_imnet": ([200, 1], [201, 64, 64, 256, 64]),
    "flow_imnet": ([64, 192, 6, 1], [263, 64, 64, 256, 4]),
    "encode_imnet": ([64, 64, 192, 192, 6, 6, 1],
                     [525, 64, 64, 256, 256, 3]),
}
# published dense peaks without sparsity (NVIDIA data sheets): fp32 on the
# CUDA cores, and device-memory bandwidth
PEAKS = {"SXM": (67e12, 3.35e12), "PCIe": (51e12, 2.0e12)}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def siren_net(rng, widths, device):
    """SIREN-init weights (in, out) and biases for one net."""
    import torch

    ws, bs = [], []
    for i in range(len(widths) - 1):
        n = widths[i]
        bound = 1.0 / n if i == 0 else np.sqrt(6.0 / n) / 30.0
        ws.append(torch.tensor(rng.uniform(-bound, bound,
                                           (n, widths[i + 1])),
                               dtype=torch.float32, device=device))
        bs.append(torch.tensor(rng.uniform(-1, 1, widths[i + 1]) / np.sqrt(n),
                               dtype=torch.float32, device=device))
    return ws, bs


def check(name, xs, ws, bs) -> float:
    """max|kernel - plain| of one net on the card; raises above the bar."""
    import torch
    from stif_tpu_torch.ops import siren_apply_fused, siren_apply_fused_plain

    got = siren_apply_fused(xs, ws, bs)
    torch.cuda.synchronize()
    err = (got - siren_apply_fused_plain(xs, ws, bs)).abs().max().item()
    log(f"  {name} Q={got.numel() // got.shape[-1]}: "
        f"max|kernel - plain| = {err:.3e}")
    if not err <= KERNEL_BAR:
        raise AssertionError(f"{name}: kernel disagrees with plain "
                             f"({err} > {KERNEL_BAR})")
    return err


def decoder_fields(name, nt, Q, device):
    """One net's fields laid out as the decoder hands them over, for nt
    query times of Q rows each: ``expand`` views over the time axis (row
    period Q), column slices of 198-wide tensors (row stride 198 floats, so
    rows are 8-byte aligned), and contiguous tensors."""
    import torch

    def r(*shape):
        return torch.rand(*shape, device=device) * 2 - 1

    def tile_t(v):
        return v.expand(nt, *v.shape)

    pe = r(nt, Q, 1)
    if name == "feat_imnet":
        return [tile_t(r(Q, 200)), pe]
    if name == "flow_imnet":
        q_b = r(Q, 198)
        return [r(nt, Q, 64), tile_t(q_b[..., :192]), tile_t(q_b[..., 192:]),
                pe]
    c1, c2 = r(nt, Q, 198), r(nt, Q, 198)
    return [r(nt, Q, 64), r(nt, Q, 64), c1[..., :192], c2[..., :192],
            c1[..., 192:], c2[..., 192:], pe]


def layout_checks(name, ws, bs, device) -> float:
    """The kernel against plain at the decoder's field layouts, with ragged
    row counts around the kernel's tile; returns the largest max|d|."""
    from stif_tpu_torch.ops.siren_fused import launch_plan

    tile = launch_plan(NETS[name][0], NETS[name][1]).tile_rows
    worst = 0.0
    for nt in (1, 3):  # 3: fields broadcast over time, row period < rows
        for Q in (1, tile - 1, tile, tile + 1, 65537):
            xs = decoder_fields(name, nt, Q, device)
            worst = max(worst, check(f"{name} layouts nt={nt}", xs, ws, bs))
    return worst


def sine_check(device) -> None:
    """The kernel's own sine against a float64 sine of the same fp32
    argument, through a 1 -> 4 -> 4 net with an identity last layer: small
    arguments, arguments up to the end of its fast range (1e5), and beyond
    it (1e8), where it hands over to ``sinf``."""
    import torch
    from stif_tpu_torch.ops import siren_apply_fused

    w0 = torch.full((1, 4), 1.0 / 30.0, device=device)
    ws, bs = [w0, torch.eye(4, device=device)], [torch.zeros(4, device=device)] * 2
    for scale in (1e2, 1e5, 1e8):
        x = (torch.rand(1 << 20, 1, device=device) * 2 - 1) * scale
        got = siren_apply_fused([x], ws, bs)
        torch.cuda.synchronize()
        arg = 30.0 * (x * w0)  # the kernel's argument, rounded as it rounds
        err = (got.double() - torch.sin(arg.double())).abs().max().item()
        log(f"  sine, |argument| <= {scale:.0e}: max|kernel - float64 sin| "
            f"= {err:.3e}")
        if not err <= SINE_BAR:
            raise AssertionError(f"kernel sine off by {err} > {SINE_BAR}")


def kernel_phase(device, peaks):
    """The fused SIREN kernel against its plain version, then timed at the
    main path's row count. Returns (max|d|, ms, plain_ms, bound_ms,
    bound_by), times summed over the three nets of one window."""
    import torch
    from stif_tpu_torch.ops import siren_apply_fused, siren_apply_fused_plain
    from stif_tpu_torch.ops.siren_fused import blocks_per_sm, launch_plan

    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    rows = N_TIMES * LR_HW[0] * SCALE * LR_HW[1] * SCALE
    sines = rows * sum(sum(widths[1:-1]) for _, widths in NETS.values())
    log(f"  per window the three nets also take {sines} precise sinf "
        f"({sines // rows} per row); the bound below counts matrix FLOPs "
        "only")
    sine_check(device)
    worst = 0.0
    ms = plain_ms = ops_ms = bytes_ms = 0.0
    for name, (splits, widths) in NETS.items():
        ws, bs = siren_net(rng, widths, device)
        plan = launch_plan(splits, widths)
        log(f"  {name} plan: {plan.tile_rows} rows x {plan.threads} threads, "
            f"tile widths {plan.pitch}, K-chunks {plan.kc}, "
            f"{len(plan.chunks)} first-layer chunks, {plan.smem_bytes} B "
            f"shared, {blocks_per_sm(plan)} blocks per SM")
        for q in (65536, 65537):
            xs = [torch.tensor(rng.uniform(-1, 1, (q, c)),
                               dtype=torch.float32, device=device)
                  for c in splits]
            worst = max(worst, check(name, xs, ws, bs))
        worst = max(worst, layout_checks(name, ws, bs, device))
        xs = [torch.rand(rows, c, device=device) * 2 - 1 for c in splits]
        worst = max(worst, check(name, xs, ws, bs))
        k_ms = cuda_ms(lambda: siren_apply_fused(xs, ws, bs), 5)
        p_ms = cuda_ms(lambda: siren_apply_fused_plain(xs, ws, bs), 3)
        flops = 2 * rows * sum(a * b for a, b in zip(widths, widths[1:]))
        n_params = sum(w.numel() + b.numel() for w, b in zip(ws, bs))
        nbytes = 4 * (rows * (widths[0] + widths[-1]) + n_params)
        o_ms, y_ms = 1e3 * flops / peaks[0], 1e3 * nbytes / peaks[1]
        b_ms = max(o_ms, y_ms)
        log(f"  {name} Q={rows}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
            f"bound {b_ms:.3f} ms ({flops / 1e9:.1f} GFLOP, "
            f"{nbytes / 1e9:.2f} GB), {flops / k_ms / 1e9:.2f} TFLOP/s")
        ms, plain_ms = ms + k_ms, plain_ms + p_ms
        ops_ms, bytes_ms = ops_ms + o_ms, bytes_ms + y_ms
        del xs
    torch.cuda.empty_cache()
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    return worst, ms, plain_ms, max(ops_ms, bytes_ms), bound_by


def set_fused(model, fused: bool) -> None:
    from stif_tpu_torch.nn import Siren

    for m in model.modules():
        if isinstance(m, Siren):
            m.fused = fused


def profile_window(pipe, frames, times, window_ms: float,
                   card: str) -> None:
    """Device time of one window by kernel (``torch.profiler``), and the
    device's idle share of an unprofiled window's wall time ``window_ms``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pipe.render_window(frames, times)
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in rows)
    if not rows:
        log("  profile: the profiler saw no device time (not measured)")
        return
    log(f"  profile: device busy {busy:.1f} ms per window; idle share "
        f"{1 - busy / window_ms:.3f} of the unprofiled {window_ms:.1f} ms "
        f"[{card}]")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"    {ms:8.2f} ms {100 * ms / busy:5.1f} %  x{count:<5d} "
            f"{key[:90]}")


def main_path(card: str):
    """The deployed model through ``InferencePipeline.render_window``.
    Returns the SIREN launch count of the driven windows."""
    import torch
    from stif_tpu_torch.convert import load_pth
    from stif_tpu_torch.models import LunaTokis
    from stif_tpu_torch.ops import siren_apply_fused
    from stif_tpu_torch.runtime import InferencePipeline

    model = LunaTokis(rgb_skip=True, rgb_skip_bicubic=True)
    load_pth(model, str(WEIGHTS))  # strict
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  loaded {WEIGHTS.name} strictly: {n_params} parameters")
    pipe = InferencePipeline(model)  # CUDA by default
    rng = np.random.default_rng(0)
    frames = rng.random((2,) + LR_HW + (3,)).astype(np.float32)
    times = [i / N_TIMES for i in range(N_TIMES)]

    siren_apply_fused.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = pipe.render_window(frames, times)  # warm-up
    window_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        pipe.render_window(frames, times)
        window_s.append(time.perf_counter() - t0)
    launches = siren_apply_fused.launches
    peak = torch.cuda.max_memory_allocated()
    n_windows = 4
    expect = (N_TIMES, LR_HW[0] * SCALE, LR_HW[1] * SCALE, 3)
    if out.shape != expect or not np.isfinite(out).all():
        raise AssertionError(f"bad window: shape {out.shape}, finite "
                             f"{np.isfinite(out).all()}")
    if launches != 3 * n_windows:
        raise AssertionError(f"{launches} SIREN launches in {n_windows} "
                             "windows, expected 3 per window")
    log(f"  window {out.shape}, finite, SIREN launches {launches} in "
        f"{n_windows} windows (3 per window)")
    win = float(np.mean(window_s))
    log(f"  render_window: {1e3 * win:.1f} ms/window "
        f"(runs {', '.join(f'{1e3 * s:.1f}' for s in window_s)} ms), "
        f"{N_TIMES / win:.2f} frames/s, peak memory "
        f"{peak / 2**30:.2f} GiB [{card}]")

    # encode / decode split on device tensors (CUDA events)
    x = torch.from_numpy(frames[None]).to(pipe.device)
    t = torch.tensor(times, device=pipe.device)
    enc, dec = [], []
    with torch.inference_mode():
        for i in range(4):
            e0, e1, e2 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(3))
            e0.record()
            feat = model.gen_feat(x)
            e1.record()
            model.decode(feat, x, t)
            e2.record()
            torch.cuda.synchronize()
            if i:
                enc.append(e0.elapsed_time(e1))
                dec.append(e1.elapsed_time(e2))
    log(f"  split: encode (gen_feat) {np.mean(enc):.1f} ms, decode "
        f"{np.mean(dec):.1f} ms [{card}]")
    profile_window(pipe, frames, times, 1e3 * win, card)

    # the same window with the plain SIREN on the card
    set_fused(model, False)
    t0 = time.perf_counter()
    plain = pipe.render_window(frames, times)
    plain_s = time.perf_counter() - t0
    set_fused(model, True)
    err = float(np.abs(out - plain).max())
    log(f"  plain-SIREN window: max|d| = {err:.3e}, "
        f"{1e3 * plain_s:.1f} ms/window [{card}]")
    if not err <= WINDOW_BAR:
        raise AssertionError(f"kernel window vs plain window: {err}")

    # a small window against the port on the CPU
    small = rng.random((2, 16, 16, 3)).astype(np.float32)
    gpu = pipe.render_window(small, times[:2])
    cpu_model = LunaTokis(rgb_skip=True, rgb_skip_bicubic=True)
    load_pth(cpu_model, str(WEIGHTS))
    ref = InferencePipeline(cpu_model, device="cpu").render_window(
        small, times[:2])
    err = float(np.abs(gpu - ref).max())
    log(f"  16x16 window, GPU (kernel) vs CPU (plain): max|d| = {err:.3e}")
    if gpu.shape != ref.shape or not err <= WINDOW_BAR:
        raise AssertionError(f"GPU vs CPU window: {err}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from stif_tpu_torch.ops import cuda_build
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    device = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    peaks = PEAKS["PCIe" if "PCIe" in name else "SXM"]
    log(f"[1] device: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("    TF32 off: cudnn.allow_tf32 = False, cuda.matmul.allow_tf32 = "
        "False (fp32 parity)")

    t0 = time.perf_counter()
    logs = cuda_build.build(["siren_fused"])
    log(f"[2] build: {time.perf_counter() - t0:.1f} s")
    for kname, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {kname}: {line.strip()}")

    log("[3] kernels vs plain, then timed at the main path's shapes")
    err, ms, plain_ms, bound_ms, bound_by = kernel_phase(device, peaks)
    torch.cuda.synchronize()
    if "--kernels" in sys.argv[1:]:
        log(f"    kernels: max|d| {err:.3e}, {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms [{card}]")
        return 0

    log("[4] main path: InferencePipeline.render_window, trained weights")
    launches = main_path(card)

    kernels = {"kernels": [{
        "name": "siren_fused",
        "route": "cuda",
        "source": "stif_tpu_torch/csrc/siren_fused.cu",
        "replaces": "stif_tpu/ops/siren_pallas.py:32",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}
    log(f"[5] done in {time.perf_counter() - t_start:.1f} s; kernel times "
        "are the sum of the three nets of one window")
    log(card)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
