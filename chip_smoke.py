#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``stif_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. In order:

1. device: the card's name and power limit; TF32 off for cuDNN convs and
   matmuls (fp32 parity with the JAX reference);
2. build: every CUDA kernel of the port, from ``stif_tpu_torch/csrc``
   (``siren_fused.cu``, ``deform_conv.cu``), one ``nvcc`` per source, all
   started together;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the decoder's three nets with their real field splits (max|d| <= 1e-4):
   contiguous fields, then the decoder's real layouts (column slices of a
   198-wide tensor, fields broadcast over the time axis, ragged row
   counts), and the kernel's sine against a float64 sine; then timed at the main path's shapes (LR 96x160, 8 times, x4);
3b. the DCN kernels (``dcn_forward``, the fused sample-and-contract
   forward, and ``dcn_backward``) against their plain versions at the
   encoder's levels L1 96x160, L2 48x80, L3 24x40 (B 1) with the trained
   offsets of the main path's first alignment and with offsets of +-6 px,
   zero offsets at L1, a training batch's levels (B 4, 48, 24, 12), stride
   2, dilation 2 and ``shift_bound`` 2: the forward within 1e-4, the
   gradients of x, offset, mask and weight within 1e-4 x max|g|, and the
   op's forward (1e-4) and its gradients of x, offset, mask, weight and bias
   (1e-4 x max|g|) against autograd through the plain forward; then timed
   at L1 (each kernel, the op's backward, their plain versions and bounds:
   the products at 3 TF32 passes on the tensor cores, the fp32 figure
   beside) and at each of the window's six call shapes (L1, L2, L3 at B 1
   and B 2), summed over a window's 42 calls beside the window's bound;
4. main path: the deployed full-width model (``rgb_skip`` bicubic) with the
   trained weights ``weights/trained_best_G.pth`` through
   ``InferencePipeline.render_window`` on a seeded 96x160 LR pair at 8 times:
   shape and finiteness, kernel launches per window, the same window with
   the plain SIREN (max|d| <= 1e-3), a small window against the port on the
   CPU (max|d| <= 1e-3), timings, and one window's device time by kernel;
   42 ``dcn_forward`` launches per window, the window with the plain DCN
   (max|d| <= 1e-3), both timed in 5 alternating runs and profiled;
5. the rest of the serving surface, same model, weights and pair:
   a. the kernel against plain at the chunked stages' shapes (8 x 65,536
      rows, separate contiguous fields), at a batch of two (fields broadcast
      over time with period B*Q) and at a padded last chunk;
   b. ``ChunkedDecoder.decode`` against the full ``decode`` of the same
      features (max|d| <= 1e-4, 12 launches);
   c. ``render_pairs`` of two different pairs against ``render_window`` of
      each (max|d| <= 1e-3);
   d. local-ensemble and test-mode windows (shape, finite, 12 and 3
      launches, the plain-SIREN window and a 16x16 window on the CPU within
      1e-3), and a 64x64 ``decode_zoom`` window against the CPU;
   e. each knob against the fp32 window, under the JAX package's own bars
      (``mlp_dtype`` must launch the kernel 0 times);
   f. one production-size window through the chunked path, LR 270x480 ->
      8 x 1080x1920: finite, ms and peak memory;
   g. the quality line: PSNR at t = 0 and t = 0.5 on two seeded synthetic
      scenes for the kernel, the plain SIREN and the plain DCN (each within
      0.01 dB) and each knob;
7. the model zoo, on weights drawn from a seeded ``torch.Generator`` with
   every DCN offset conv perturbed (every model runs the DCN kernels on the
   card and is held against the CPU's plain versions):
   a. the kernel against plain at the six nets of ``LunaTokisTrain``,
      ``LunaTokisS`` and ``LunaTokisNoFlow`` with their real field layouts
      (max|d| <= 1e-4), then timed at 1,966,080 rows beside each net's bound;
   b. those three at full width (nf 64, groups 8, 5 + 40 blocks) on the
      96x160 pair at 8 times: shape, finite, exactly 3 / 2 / 1 launches, the
      same forward with the plain SIREN and a 16x16 window on the CPU within
      1e-3, ms and peak memory;
   c. ``LunaTokisZSM`` and ``TMNet`` at full width (TMNet through
      ``render_window_tmnet``, 4 frames and 5 times, 19 frames out; and
      without times): 0 launches, a small window against the CPU, ms;
   d. every ``LIIF_<preset>`` through ``define_g`` from a plain dict, and
      ``decode_mulfeat`` on ``test4``: finite, against the CPU, 0 launches;
   e. ``eval_adobe_tmnet`` and ``eval_vid4_tmnet`` on rendered folders:
      finite PSNR and SSIM;
8. training at the full width of ``configs/train_synthetic_r5.yml`` (the
   options built as a dict, weights from ``nn/init.py`` under seed 0):
   a. ``VideoSRModel`` on ``create_train_dataset``'s batches at the x4, x2
      and x8 buckets (B 4, nt 3): 2 warm-up and 6 timed steps each, per
      step the bucket, loss and grad norm; then ms per step by CUDA events
      (median, min, max), the forward / backward / optimizer split,
      samples/s, peak memory, and at x4 one profiled step's top kernels and
      the device's idle share; no SIREN launch, 78 ``dcn_forward`` (42,
      and 36 recomputed by the ConvLSTM's remat) and 42 ``dcn_backward``
      launches a step;
   b. ten steps on one fixed x4 batch with warmup off: the loss falls;
   c. one step from the same init on the card and on the CPU (B 1, LR
      16x16, nt 2): loss within rtol 1e-4, grad norm within rtol 1e-3, and
      the largest per-parameter gradient difference; the card's step runs
      the DCN kernels (78 forward and 42 backward launches);
   d. save after [8b]'s steps, resume into a fresh model: params, Adam
      moments, step and EMA bitwise equal, the next loss within rtol 1e-5;
   e. a ``Validator`` probe (1 dev scene, 144x192) through the kernel and
      through the plain SIREN: Y-PSNR within 0.01 dB; ``BestTracker``'s
      ``best.json`` read back by ``eval_model_torch``'s ``--best`` loader;
   f. ``scripts/train_torch.py``'s ``run`` for 20 steps (validation and
      checkpoints every 10), then resumed to 25;
9. parallelism and streaming:
   a. the data-parallel train step (DDP over NCCL at world size 1, started
      in this process on a free port) against the single-process step from
      the same seed-0 init, r5 config at full width, x4 bucket, 3 steps:
      loss within rtol 1e-5, grad norm within rtol 1e-4, the largest
      per-parameter gap; then ms per step of each, median of 5 alternating;
   b. ``python -m torch.distributed.run --nproc_per_node 1
      scripts/train_torch.py --parallel`` for 6 steps (checkpoint at 5),
      then resumed without ``--parallel`` to 8: both exit 0;
   c. ``ChunkedDecoder`` over a mesh of two handles of ``cuda:0`` (n_par 2)
      against one device on the main path's window (max|d| <= 1e-5, 12
      launches), and ``default_mesh()`` (size 1) bitwise equal to no mesh;
   d. ``render_sequence`` of 5 frames (4 pairs) double-buffered against
      ``render_window`` of each pair back to back: bitwise equal, 12
      launches, ms per pair both ways (3 alternating runs);
   e. ``backward_warp``, ``warp_grid_coords`` and ``deform_psroi_pool`` on
      the card against the CPU (<= 1e-5); the native host resize, built
      here with ``g++``, against its plain version (<= 1e-5) and ms per
      1080p frame both ways;
10. the bench (``stif_tpu_torch/runtime/bench.py``, the workload of
   ``scripts/bench_torch.py``) at the deployed config, trained weights and
   ``bench.py``'s sizes: ``bench_b1`` over 4 pairs (3 SIREN and 42
   ``dcn_forward`` launches per window), ``bench_batched`` over the same
   pairs in 2 batches of 2, ``full`` and through the ``ChunkedDecoder``
   (chunk 65,536): each batch's uint8 frames against the b1 frames of its
   pairs and chunked against full, within 1 LSB; frames/s, peak memory and
   ``mfu`` (FLOPs from the module shapes over wall time per window over
   the fp32 peak, in (0, 1]); then ``scripts/bench_torch.py`` once as a
   subprocess (exit 0, its line parses and is logged) and the profile of
   one streamed window (``runtime/profile.py``; its line is logged);
6. the ``kernels`` JSON line (launches summed over every path driven; the
   DCN kernels' times are of one L1 call), then the result line.

Any failed check raises and the script exits non-zero; without a CUDA
device it exits 2 and prints no result. ``python3 chip_smoke.py --kernels``
stops after phases 3, 3b, 5a and 7a and prints no result line (for work on
a kernel). Every path counts the launches of each kernel: a path through an
encoder must launch the DCN forward kernel, a decode of given features must
not.
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
CHUNK = 65536       # ChunkedDecoder's default chunk of queries
PSNR_BAR = 0.01     # dB, kernel vs plain SIREN on the quality scenes
HD_LR_HW = (270, 480)  # x4 -> 1080x1920
# the decoder's three nets: field splits and layer widths (input first)
NETS = {
    "feat_imnet": ([200, 1], [201, 64, 64, 256, 64]),
    "flow_imnet": ([64, 192, 6, 1], [263, 64, 64, 256, 4]),
    "encode_imnet": ([64, 64, 192, 192, 6, 6, 1],
                     [525, 64, 64, 256, 256, 3]),
}
# the six nets of the model zoo (phase 7): LunaTokisTrain's three,
# LunaTokisS's two and LunaTokisNoFlow's one, at nf 64 and an input pair
ZOO_NETS = {
    "train_feat": ([200], [200, 64, 64, 64, 256, 128]),
    "train_flow": ([128, 200, 1], [329, 64, 64, 64, 256, 4]),
    "train_encode": ([128, 198, 128, 198],
                     [652, 64, 64, 64, 256, 256, 27]),
    "s_flow": ([200, 1], [201, 64, 64, 256, 4]),
    "s_encode": ([192, 192, 6, 6], [396, 64, 64, 256, 256, 3]),
    "noflow_feat": ([200, 1], [201, 64, 64, 256, 256, 256, 3]),
}
# published dense peaks without sparsity (NVIDIA data sheets): fp32 on the
# CUDA cores, device-memory bandwidth, and TF32 on the tensor cores
PEAKS = {"SXM": (67e12, 3.35e12, 495e12), "PCIe": (51e12, 2.0e12, 378e12)}
# DCN calls per LR pair: 13 alignments of 6 DCNs (one in gen_feat, two per
# ConvLSTM step over 3 steps in each direction); the port runs the two
# directions as one batch, so 7 pyramids of 6 calls
DCN_PER_PAIR = 42
DCN_BAR = 1e-4      # DCN kernels vs plain: forward max|d|, gradients / max|g|
DCN_LEVELS = {"L1": (96, 160), "L2": (48, 80), "L3": (24, 40)}
# a window's DCN calls by shape: each of the 7 pyramids runs 2 DCNs at each
# level, gen_feat's at B 1 and the ConvLSTM's 6 at B 2 (both directions)
DCN_WINDOW_CALLS = {(lvl, b): 2 * n for lvl in DCN_LEVELS
                    for b, n in ((1, 1), (2, 6))}
DCN_STEP_FORWARD = 78  # a train step: 42, and 36 recomputed by remat
DCN_ALTERNATIONS = 5  # [4]: windows timed with the DCN kernels and plain


def log(msg: str) -> None:
    print(msg, flush=True)


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


def time_net(name, xs, ws, bs, peaks):
    """Kernel and plain ms of one net on fields ``xs``, and the least ms the
    card could take by operations (2 FLOPs per weight and row at the fp32
    peak) and by bytes (each field's stored rows, the parameters and the
    output once, at the memory rate)."""
    from stif_tpu_torch.ops import siren_apply_fused, siren_apply_fused_plain
    from stif_tpu_torch.ops.siren_fused import _field_layout

    rows = xs[0].shape[:-1].numel()
    k_ms = cuda_ms(lambda: siren_apply_fused(xs, ws, bs), 5)
    p_ms = cuda_ms(lambda: siren_apply_fused_plain(xs, ws, bs), 3)
    flops = 2 * rows * sum(w.numel() for w in ws)
    stored = sum(width * period for width, _, period in
                 (_field_layout(v, rows) for v in xs))
    n_params = sum(w.numel() + b.numel() for w, b in zip(ws, bs))
    nbytes = 4 * (stored + rows * ws[-1].shape[1] + n_params)
    o_ms, y_ms = 1e3 * flops / peaks[0], 1e3 * nbytes / peaks[1]
    log(f"  {name} Q={rows}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
        f"bound {max(o_ms, y_ms):.3f} ms ({flops / 1e9:.1f} GFLOP, "
        f"{nbytes / 1e9:.2f} GB), {flops / k_ms / 1e9:.2f} TFLOP/s")
    return k_ms, p_ms, o_ms, y_ms


def kernel_phase(device, peaks):
    """The fused SIREN kernel against its plain version, then timed at the
    main path's row count. Returns (max|d|, ms, plain_ms, bound_ms,
    bound_by), times summed over the three nets of one window."""
    import torch
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
        k_ms, p_ms, o_ms, y_ms = time_net(name, xs, ws, bs, peaks)
        ms, plain_ms = ms + k_ms, plain_ms + p_ms
        ops_ms, bytes_ms = ops_ms + o_ms, bytes_ms + y_ms
        del xs
    torch.cuda.empty_cache()
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    return worst, ms, plain_ms, max(ops_ms, bytes_ms), bound_by


# ---------------------------------------------------------------- phase 3b

def first_alignment(device):
    """The inputs of the six DCNs of the main path's first alignment
    (``gen_feat``'s ``PCDAlign``) on phase 4's seeded pair with the trained
    weights: ``{name: (x, offset view, mask, weight, bias)}``."""
    import torch
    from stif_tpu_torch.nn.dcn import DCNSep
    from stif_tpu_torch.ops import split_offset_mask

    model = deployed_model().to(device).eval()
    frames = np.random.default_rng(0).random((2,) + LR_HW + (3,)).astype(
        np.float32)
    seen = {}

    def hook(name):
        def fn(mod, args, out):
            x, fea = args
            off, mask = split_offset_mask(mod.conv_offset_mask(fea),
                                          mod.deformable_groups,
                                          mod.kernel_size)
            seen[name] = (x, off, mask, mod.weight.detach(),
                          mod.bias.detach())
        return fn

    hooks = [m.register_forward_hook(hook(n)) for n, m in
             model.pcd_align.named_modules() if isinstance(m, DCNSep)]
    with torch.no_grad():
        model.gen_feat(torch.from_numpy(frames[None]).to(device))
    for h in hooks:
        h.remove()
    return seen


def dcn_case(device, B, hw, scale, stride=1, dilation=1, seed=0):
    """x, a strided offset view of a raw conv output (offsets uniform in
    +-``scale`` px), mask, weight and bias of a 64-channel DCN, 8 groups."""
    import torch
    from stif_tpu_torch.ops import split_offset_mask

    g = torch.Generator().manual_seed(seed)
    H, W = hw
    Ho = (H + 2 - 2 * dilation - 1) // stride + 1
    Wo = (W + 2 - 2 * dilation - 1) // stride + 1
    x = torch.randn(B, H, W, 64, generator=g)
    raw = torch.rand(B, Ho, Wo, 216, generator=g) * 2 - 1
    raw[..., :144] *= scale
    off, mask = split_offset_mask(raw.to(device), 8, 3)  # views on the card
    w = torch.randn(64, 64, 3, 3, generator=g) / 24.0
    b = torch.randn(64, generator=g) * 0.1
    return [x.to(device), off, mask, w.to(device), b.to(device)]


def dcn_check(label, inputs, stride=1, dilation=1, shift_bound=None):
    """Each DCN kernel against its plain version, then the op (forward and
    the gradients of x, offset, mask, weight and bias) against autograd
    through the plain forward. Returns (max|d| of the forward, max|d| of
    the backward kernel's gradients)."""
    import torch
    from stif_tpu_torch.ops import (dcn_backward, dcn_backward_plain,
                                    dcn_forward, dcn_forward_plain,
                                    deform_conv2d, deform_conv2d_plain)

    x, off, mask, w, b = inputs
    geo = (stride, 1, dilation, shift_bound)
    out = dcn_forward(x, off, mask, w, b, *geo)
    err_f = (out - dcn_forward_plain(x, off, mask, w, b, *geo)
             ).abs().max().item()
    g_out = torch.randn_like(out)
    got = dcn_backward(g_out, x, off, mask, w, *geo)
    err_b, rel_b = 0.0, 0.0
    for g, want in zip(got, dcn_backward_plain(g_out, x, off, mask, w, *geo)):
        d = (g - want).abs().max().item()
        err_b = max(err_b, d)
        rel_b = max(rel_b, d / max(want.abs().max().item(), 1e-30))
    kw = dict(stride=stride, dilation=dilation,
              impl="patch" if shift_bound is None else "dense",
              shift_bound=shift_bound)
    cot = torch.randn(*off.shape[:3], w.shape[0], device=x.device)
    res = []
    for op in (deform_conv2d, deform_conv2d_plain):
        ins = [v.detach().requires_grad_(True) for v in inputs]  # views kept
        y = op(*ins, **kw)
        (y * cot).sum().backward()
        res.append([y.detach()] + [v.grad for v in ins])
    torch.cuda.synchronize()
    err_y = (res[0][0] - res[1][0]).abs().max().item()
    rel_g = max((g - want).abs().max().item()
                / max(want.abs().max().item(), 1e-30)
                for g, want in zip(res[0][1:], res[1][1:]))
    log(f"  {label}: forward max|d| {err_f:.3e}; backward kernel max|d| "
        f"{err_b:.3e} ({rel_b:.3e} of max|g|); op forward max|d| "
        f"{err_y:.3e}, gradients x / offset / mask / weight / bias "
        f"{rel_g:.3e} of max|g|")
    if not (err_f <= DCN_BAR and err_y <= DCN_BAR and rel_b <= DCN_BAR
            and rel_g <= DCN_BAR):
        raise AssertionError(f"{label}: a DCN kernel disagrees with its plain "
                             f"version (bar {DCN_BAR})")
    return err_f, err_b


def dcn_bounds(x, off, cout, peaks):
    """Least ms of the DCN's forward and backward at one call's shapes:
    {piece: (operations ms, bytes ms, operations ms with the products at
    the fp32 peak)}. Bytes: each input read once, each output written once
    (forward: x, offset, mask, weight, bias, out; backward: grad_out, x,
    offset, mask, weight and the gradients of x, offset, mask, weight).
    Operations: the products at the rate the kernels run them, three TF32
    passes on the tensor cores, plus the sampling's fp32 multiply-adds on
    the CUDA cores (7 per column element forward, 23 backward)."""
    B, H, W, cin = x.shape
    rows = off.shape[:5].numel()            # (b, q, g, k) samples
    n_cols = rows * (cin // off.shape[3])   # column elements
    Q = off.shape[:3].numel()
    x_b, off_b, m_b = 4 * x.numel(), 8 * rows, 4 * rows
    w_b, out_b = 4 * 9 * cin * cout, 4 * Q * cout
    mm = 2 * Q * 9 * cin * cout             # one (Q, K*Cin) x (K*Cin, Cout)
    work = {  # (product FLOPs, sampling FLOPs, bytes)
        "forward": (mm, 7 * n_cols, x_b + off_b + m_b + w_b + 4 * cout
                    + out_b),
        "backward": (2 * mm, 23 * n_cols,
                     out_b + 2 * (x_b + off_b + m_b + w_b)),
    }
    fp32, bw, tf32 = peaks
    return {k: (1e3 * (3 * p / tf32 + f / fp32), 1e3 * n / bw,
                1e3 * (p + f) / fp32)
            for k, (p, f, n) in work.items()}


def dcn_times(inputs, peaks, card, reps=20):
    """ms of each DCN kernel and of the op's backward (autograd, bias sum
    included) against the plain versions (CUDA events), beside the bound of
    each. Returns {piece: (ms, plain ms, bound ms, bound by)}."""
    import torch
    from stif_tpu_torch.ops import (dcn_backward, dcn_backward_plain,
                                    dcn_forward, dcn_forward_plain,
                                    deform_conv2d, deform_conv2d_plain)

    x, off, mask, w, b = inputs
    cot = torch.randn(*off.shape[:3], w.shape[0], device=x.device)
    with torch.no_grad():
        pieces = {
            "forward": (lambda: dcn_forward(x, off, mask, w, b),
                        lambda: dcn_forward_plain(x, off, mask, w, b)),
            "backward": (lambda: dcn_backward(cot, x, off, mask, w),
                         lambda: dcn_backward_plain(cot, x, off, mask, w)),
        }
        ms = {k: (cuda_ms(fk, reps), cuda_ms(fp, 5))
              for k, (fk, fp) in pieces.items()}
    bwd = []
    for op in (deform_conv2d, deform_conv2d_plain):
        ins = [v.detach().requires_grad_(True) for v in inputs]  # views kept
        y = op(*ins)
        bwd.append(cuda_ms(lambda: y.backward(cot, retain_graph=True),
                           reps if op is deform_conv2d else 5))
    bounds = dcn_bounds(x, off, w.shape[0], peaks)
    out = {}
    for k, (o_ms, y_ms, f_ms) in bounds.items():
        by = "operations" if o_ms >= y_ms else "bytes"
        out[k] = (*ms[k], max(o_ms, y_ms), by)
        log(f"  {k:8s}: kernel {ms[k][0]:.4f} ms, plain {ms[k][1]:.4f} ms, "
            f"bound {max(o_ms, y_ms):.4f} ms ({by}; operations {o_ms:.4f} "
            f"at 3xTF32, {f_ms:.4f} at the fp32 peak; bytes {y_ms:.4f}), "
            f"{100 * max(o_ms, y_ms) / ms[k][0]:.0f} % of the bound "
            f"[{card}]")
    log(f"  op backward (autograd, bias sum included): {bwd[0]:.4f} ms, "
        f"plain {bwd[1]:.4f} ms [{card}]")
    return out


def dcn_window_times(trained, device, peaks, card):
    """The DCN kernels at each of a window's call shapes (the trained
    inputs of L1, L2, L3; B 2 as the batch repeated), and their sum over a
    window's 42 calls beside the window's bound: {piece: (ms, bound ms)}."""
    import torch
    from stif_tpu_torch.ops import dcn_backward, dcn_forward

    total = {"forward": [0.0, 0.0], "backward": [0.0, 0.0]}
    for (lvl, B), n in DCN_WINDOW_CALLS.items():
        x, off, mask, w, b = trained[f"{lvl}_dcnpack_1"]
        if B == 2:
            x, off, mask = (torch.cat([v, v]) for v in (x, off, mask))
        cot = torch.randn(*off.shape[:3], w.shape[0], device=device)
        with torch.no_grad():
            f_ms = cuda_ms(lambda: dcn_forward(x, off, mask, w, b), 20)
            b_ms = cuda_ms(lambda: dcn_backward(cot, x, off, mask, w), 20)
        bounds = dcn_bounds(x, off, w.shape[0], peaks)
        for k, v in (("forward", f_ms), ("backward", b_ms)):
            bound = max(bounds[k][:2])
            total[k][0] += n * v
            total[k][1] += n * bound
        log(f"  {lvl} B {B} ({n} calls a window): forward {f_ms:.4f} ms "
            f"(bound {max(bounds['forward'][:2]):.4f}), backward "
            f"{b_ms:.4f} ms (bound {max(bounds['backward'][:2]):.4f}) "
            f"[{card}]")
    for k, (ms, bound) in total.items():
        log(f"  a window's {sum(DCN_WINDOW_CALLS.values())} calls, {k}: "
            f"{ms:.4f} ms against a bound of {bound:.4f} ms "
            f"({100 * bound / ms:.0f} %) [{card}]")
    return {k: tuple(v) for k, v in total.items()}


def dcn_kernel_phase(device, peaks, card):
    """Phase 3b: the DCN kernels against their plain versions at the
    encoder's shapes, then timed at the main path's largest call and at
    each of a window's call shapes. Returns {kernel: (max|d|, ms, plain ms,
    bound ms, bound by)}."""
    import torch
    from stif_tpu_torch.ops.deform_conv import blocks_per_sm, launch_plan

    trained = first_alignment(device)
    errs = []
    for lvl, hw in DCN_LEVELS.items():
        errs.append(dcn_check(f"{lvl} {hw[0]}x{hw[1]} B 1, trained offsets",
                              trained[f"{lvl}_dcnpack_1"]))
        errs.append(dcn_check(f"{lvl} {hw[0]}x{hw[1]} B 1, offsets +-6 px",
                              dcn_case(device, 1, hw, 6.0, seed=1)))
    l1 = "L1 {}x{} B 1".format(*DCN_LEVELS["L1"])
    errs.append(dcn_check(f"{l1}, zero offsets",
                          dcn_case(device, 1, DCN_LEVELS["L1"], 0.0, seed=2)))
    for k, side in enumerate((48, 24, 12)):  # a training batch's levels
        errs.append(dcn_check(f"{side}x{side} B 4, offsets +-6 px",
                              dcn_case(device, 4, (side, side), 6.0,
                                       seed=3 + k)))
    errs.append(dcn_check("48x80 B 1, stride 2, offsets +-6 px",
                          dcn_case(device, 1, (48, 80), 6.0, stride=2,
                                   seed=6), stride=2))
    errs.append(dcn_check("48x80 B 1, dilation 2, offsets +-6 px",
                          dcn_case(device, 1, (48, 80), 6.0, dilation=2,
                                   seed=7), dilation=2))
    errs.append(dcn_check(f"{l1}, shift_bound 2, offsets +-6 px",
                          dcn_case(device, 1, DCN_LEVELS["L1"], 6.0, seed=8),
                          shift_bound=2))
    x, off, _, _, _ = trained["L1_dcnpack_1"]
    Q, cin = off.shape[:3].numel(), x.shape[-1]
    fwd = launch_plan("forward", Q, cin, 8, 64)
    bwd = launch_plan("backward", Q, cin, 8, 64)
    occ = blocks_per_sm(fwd)
    log(f"  timed at {l1}, trained offsets and weights: the product "
        f"{2 * Q * 9 * cin * 64 / 1e9:.2f} GFLOP (x3 TF32 passes), no "
        f"column matrix; forward grid {fwd.grid}, {fwd.smem_bytes} B shared, "
        f"{occ[0]} block(s) per SM; backward grid {bwd.grid} "
        f"({bwd.tiles_per_block} tiles a block), {bwd.smem_bytes} B shared, "
        f"{occ[1]} blocks per SM")
    times = dcn_times(trained["L1_dcnpack_1"], peaks, card)
    dcn_window_times(trained, device, peaks, card)
    del trained
    torch.cuda.empty_cache()
    return {"dcn_forward": (max(e for e, _ in errs), *times["forward"]),
            "dcn_backward": (max(e for _, e in errs), *times["backward"])}


def device_profile(fn, wall_ms: float, what: str, card: str,
                   top: int = 12) -> None:
    """Device time of one call of ``fn`` by kernel (``torch.profiler``), and
    the device's idle share of an unprofiled call's wall time
    ``wall_ms``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in rows)
    if not rows:
        log("  profile: the profiler saw no device time (not measured)")
        return rows
    log(f"  profile: device busy {busy:.1f} ms per {what}; idle share "
        f"{1 - busy / wall_ms:.3f} of the unprofiled {wall_ms:.1f} ms "
        f"[{card}]")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        log(f"    {ms:8.2f} ms {100 * ms / busy:5.1f} %  x{count:<5d} "
            f"{key[:90]}")
    for label, words in (("DCN kernels", ("dcn_",)),
                         ("index gathers / scatters", ("index", "gather"))):
        hit = [(ms, n) for key, ms, n in rows
               if any(w in key.lower() for w in words)]
        log(f"    {label}: {sum(m for m, _ in hit):.2f} ms in "
            f"{sum(n for _, n in hit)} launches")
    return rows


def main_path(card: str):
    """The deployed model through ``InferencePipeline.render_window``.
    Returns the SIREN launch count of the driven windows."""
    import torch
    from stif_tpu_torch.convert import load_pth
    from stif_tpu_torch.models import LunaTokis
    from stif_tpu_torch.nn.dcn import set_dcn_kernel
    from stif_tpu_torch.nn.siren import set_fused
    from stif_tpu_torch.ops import dcn_backward, dcn_forward, siren_apply_fused
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
    dcn_forward.launches = dcn_backward.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = pipe.render_window(frames, times)  # warm-up
    window_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        pipe.render_window(frames, times)
        window_s.append(time.perf_counter() - t0)
    launches = siren_apply_fused.launches
    dcn = dcn_counts()
    peak = torch.cuda.max_memory_allocated()
    n_windows = 4
    expect = (N_TIMES, LR_HW[0] * SCALE, LR_HW[1] * SCALE, 3)
    if out.shape != expect or not np.isfinite(out).all():
        raise AssertionError(f"bad window: shape {out.shape}, finite "
                             f"{np.isfinite(out).all()}")
    if launches != 3 * n_windows:
        raise AssertionError(f"{launches} SIREN launches in {n_windows} "
                             "windows, expected 3 per window")
    if dcn != (DCN_PER_PAIR * n_windows, 0):
        raise AssertionError(f"DCN launches (forward, backward) {dcn} in "
                             f"{n_windows} windows, expected {DCN_PER_PAIR} "
                             "forward launches per window")
    log(f"  window {out.shape}, finite, SIREN launches {launches} in "
        f"{n_windows} windows (3 per window), dcn_forward launches "
        f"{dcn[0]} ({DCN_PER_PAIR} per window), no dcn_backward")
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
    device_profile(lambda: pipe.render_window(frames, times), 1e3 * win,
                   "window", card)

    # the same window with the plain DCN on the card, then both timed in
    # turns and profiled
    set_dcn_kernel(model, False)
    dcn_forward.launches = 0
    plain = pipe.render_window(frames, times)
    if dcn_forward.launches:
        raise AssertionError("the plain-DCN window launched a DCN kernel")
    err = float(np.abs(out - plain).max())
    log(f"  plain-DCN window: max|d| to the kernel window = {err:.3e}")
    if not err <= WINDOW_BAR:
        raise AssertionError(f"kernel window vs plain-DCN window: {err}")
    walls = {True: [], False: []}
    for _ in range(DCN_ALTERNATIONS):
        for on in (True, False):
            set_dcn_kernel(model, on)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.render_window(frames, times)
            walls[on].append(1e3 * (time.perf_counter() - t0))
    for on, what in ((True, "DCN kernels"), (False, "plain DCN")):
        log(f"  window, {what}: median {np.median(walls[on]):.1f} ms (runs "
            f"{', '.join(f'{v:.1f}' for v in walls[on])}), "
            f"{DCN_ALTERNATIONS} alternating runs [{card}]")
    for on, what in ((True, "window, DCN kernels"),
                     (False, "window, plain DCN")):
        set_dcn_kernel(model, on)
        device_profile(lambda: pipe.render_window(frames, times),
                       float(np.median(walls[on])), what, card, top=8)
    set_dcn_kernel(model, True)

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


# ----------------------------------------------------------------- phase 5

def chunk_fields(name, nt, B, Cq, device, pad_from=None):
    """One net's fields as ``decode_chunk_ab`` / ``decode_chunk_cd`` hand
    them over for nt times, a batch of B and Cq queries: separate contiguous
    gathers, the time-independent ones broadcast over the time axis (row
    period B * Cq). With ``pad_from``, queries from that index on repeat the
    one before, as in a padded last chunk."""
    import torch

    def r(*shape):
        v = torch.rand(*shape, device=device) * 2 - 1
        if pad_from is not None:
            v[..., pad_from:, :] = v[..., pad_from - 1:pad_from, :]
        return v

    def tile_t(v):
        return v.expand(nt, *v.shape)

    if name == "feat_imnet":
        return [tile_t(r(B, Cq, 200)), r(nt, B, Cq, 1)]
    if name == "flow_imnet":
        return [r(nt, B, Cq, 64), tile_t(r(B, Cq, 192)), tile_t(r(B, Cq, 6)),
                r(nt, B, Cq, 1)]
    return [r(nt * B, Cq, c) for c in NETS[name][0]]


def slice_kernel_checks(device) -> float:
    """Phase 5a; returns the largest max|kernel - plain|."""
    import torch

    rng = np.random.default_rng(1)
    torch.manual_seed(1)
    worst = 0.0
    for name, (_, widths) in NETS.items():
        ws, bs = siren_net(rng, widths, device)
        xs = chunk_fields(name, N_TIMES, 1, CHUNK, device)
        worst = max(worst, check(f"{name} chunk {N_TIMES}x{CHUNK}",
                                 xs, ws, bs))
        xs = chunk_fields(name, N_TIMES, 1, CHUNK, device,
                          pad_from=CHUNK - 16384)
        worst = max(worst, check(f"{name} padded last chunk", xs, ws, bs))
        xs = chunk_fields(name, N_TIMES, 2, 30001, device)
        worst = max(worst, check(f"{name} B=2 (period 2x30001)", xs, ws, bs))
        del xs
    torch.cuda.empty_cache()
    return worst


def dcn_counts():
    from stif_tpu_torch.ops import dcn_backward, dcn_forward

    return dcn_forward.launches, dcn_backward.launches


class Launches:
    """Counts kernel launches path by path: ``run`` sets every wrapper's
    count to 0, drives one path, checks the counts it read and adds them up.
    ``dcn`` is the (forward, backward) DCN launches the path must make;
    ``"some"`` asks for at least one forward launch, None for none at
    all."""

    def __init__(self):
        self.total = 0
        self.dcn = [0, 0]

    def run(self, what: str, expect: int, fn, dcn="some"):
        from stif_tpu_torch.ops import (dcn_backward, dcn_forward,
                                        siren_apply_fused)

        siren_apply_fused.launches = 0
        dcn_forward.launches = dcn_backward.launches = 0
        out = fn()
        n = siren_apply_fused.launches
        if n != expect:
            raise AssertionError(f"{what}: {n} SIREN launches, expected "
                                 f"{expect}")
        got = dcn_counts()
        if (got[0] == 0 if dcn == "some" else
                got != ((0, 0) if dcn is None else tuple(dcn))):
            raise AssertionError(f"{what}: DCN launches (forward, backward) "
                                 f"{got}, expected {dcn}")
        self.total += n
        self.dcn = [a + b for a, b in zip(self.dcn, got)]
        self.last = got
        return out


def deployed_model(**knobs):
    """The deployed full-width model with the trained weights."""
    from stif_tpu_torch.convert import load_pth
    from stif_tpu_torch.models import LunaTokis

    model = LunaTokis(rgb_skip=True, rgb_skip_bicubic=True, **knobs)
    load_pth(model, str(WEIGHTS))  # strict: the knobs change no parameter
    return model


TIMED_RUNS = 3  # calls of ``fn`` that ``timed`` makes


def timed(fn):
    """Wall ms of each call of ``fn`` after a first, untimed one, and the
    peak device memory in GiB over all of them; ``fn`` must end
    synchronised (here: with its result on the host)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    runs = []
    for _ in range(TIMED_RUNS - 1):
        t0 = time.perf_counter()
        fn()
        runs.append(1e3 * (time.perf_counter() - t0))
    return runs, torch.cuda.max_memory_allocated() / 2**30


def max_abs(a, b) -> float:
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {a.shape} vs {b.shape}")
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def require(what: str, value: float, ok: bool) -> None:
    log(f"  {what}: {value:.3e}")
    if not ok or not np.isfinite(value):
        raise AssertionError(f"{what}: {value} is outside its bar")


def fmt_runs(runs) -> str:
    return (f"{np.mean(runs):.1f} ms (runs "
            f"{', '.join(f'{r:.1f}' for r in runs)})")


def slice_phase(card: str, device) -> int:
    """Phases 5b-5g. Returns the ``Launches`` of every path
    driven."""
    import torch
    from stif_tpu_torch.data.synthetic import render_sequence
    from stif_tpu_torch.nn.dcn import set_dcn_kernel
    from stif_tpu_torch.nn.siren import set_fused
    from stif_tpu_torch.runtime import (ChunkedDecoder, InferencePipeline,
                                        pad_to_multiple)
    from stif_tpu_torch.runtime.eval import _score_space_time_sr

    count = Launches()
    model = deployed_model()
    pipe = InferencePipeline(model)
    rng = np.random.default_rng(0)
    frames = rng.random((2,) + LR_HW + (3,)).astype(np.float32)  # phase 4's
    other = rng.random((2,) + LR_HW + (3,)).astype(np.float32)
    small = rng.random((2, 16, 16, 3)).astype(np.float32)
    times = [i / N_TIMES for i in range(N_TIMES)]
    HH, WW = LR_HW[0] * SCALE, LR_HW[1] * SCALE
    window = count.run("render_window", 3,
                       lambda: pipe.render_window(frames, times),
                       dcn=(DCN_PER_PAIR, 0))

    log("[5b] ChunkedDecoder.decode vs the full decode of the same features")
    x = torch.from_numpy(frames[None]).to(device)
    t = torch.tensor(times, device=device)
    with torch.inference_mode():
        feat = model.gen_feat(x)
        full = count.run("decode", 3,
                         lambda: model.decode(feat, x, t).cpu().numpy(),
                         dcn=None)
    steps = -(-HH * WW // CHUNK)
    decoder = ChunkedDecoder(model, CHUNK)
    chunked = count.run("ChunkedDecoder.decode", 3 * steps,
                        lambda: decoder.decode(feat, x, t, (HH, WW)),
                        dcn=None)
    d = max_abs(chunked, full)
    require(f"chunked ({steps} steps of {CHUNK}) vs full decode, max|d|", d,
            d <= KERNEL_BAR)
    runs, peak = count.run(
        "ChunkedDecoder.decode, timed", TIMED_RUNS * 3 * steps,
        lambda: timed(lambda: decoder.decode(feat, x, t, (HH, WW))),
        dcn=None)
    with torch.inference_mode():
        full_runs, full_peak = count.run(
            "decode, timed", TIMED_RUNS * 3,
            lambda: timed(lambda: model.decode(feat, x, t).cpu().numpy()),
            dcn=None)
    log(f"  chunked decode {fmt_runs(runs)}, peak {peak:.2f} GiB; full "
        f"decode {fmt_runs(full_runs)}, peak {full_peak:.2f} GiB (host copy "
        f"included) [{card}]")
    del feat, full, chunked

    log("[5c] render_pairs of two pairs vs render_window of each")
    pairs = np.stack([frames, other])
    both = count.run("render_pairs, B = 2", 3 * steps,
                     lambda: pipe.render_pairs(pairs, times))
    if both.shape != (2, N_TIMES, HH, WW, 3):
        raise AssertionError(f"render_pairs shape {both.shape}")
    ref_other = count.run("render_window", 3,
                          lambda: pipe.render_window(other, times),
                          dcn=(DCN_PER_PAIR, 0))
    d = max(max_abs(both[0], window), max_abs(both[1], ref_other))
    require("render_pairs vs render_window, max|d|", d, d <= WINDOW_BAR)
    runs, peak = count.run(
        "render_pairs, timed", TIMED_RUNS * 3 * steps,
        lambda: timed(lambda: pipe.render_pairs(pairs, times)))
    log(f"  render_pairs, 2 pairs: {fmt_runs(runs)}, peak {peak:.2f} GiB "
        f"[{card}]")
    del both, pairs

    log("[5d] local-ensemble, test-mode and zoom windows")
    cpu_model = deployed_model()
    cpu_pipe = InferencePipeline(cpu_model, device="cpu")
    for mode, expect in (("local_ensemble", 12), ("test_mode", 3)):
        setattr(pipe, mode, True)
        setattr(cpu_pipe, mode, True)
        out = count.run(mode, expect,
                        lambda: pipe.render_window(frames, times))
        if out.shape != window.shape or not np.isfinite(out).all():
            raise AssertionError(f"{mode} window: shape {out.shape}")
        runs, peak = count.run(
            f"{mode}, timed", TIMED_RUNS * expect,
            lambda: timed(lambda: pipe.render_window(frames, times)))
        log(f"  {mode} window {out.shape}, finite, {expect} launches: "
            f"{fmt_runs(runs)}, peak {peak:.2f} GiB; max|d| to the default "
            f"window {max_abs(out, window):.3e} [{card}]")
        set_fused(model, False)
        plain = count.run(f"{mode}, plain SIREN", 0,
                          lambda: pipe.render_window(frames, times))
        set_fused(model, True)
        d = max_abs(out, plain)
        require(f"{mode}: kernel window vs plain-SIREN window, max|d|", d,
                d <= WINDOW_BAR)
        gpu = count.run(f"{mode}, 16x16", expect,
                        lambda: pipe.render_window(small, times[:2]))
        d = max_abs(gpu, cpu_pipe.render_window(small, times[:2]))
        require(f"{mode}: 16x16 window, GPU (kernel) vs CPU, max|d|", d,
                d <= WINDOW_BAR)
        setattr(pipe, mode, False)
        setattr(cpu_pipe, mode, False)
        del out, plain
    xs = torch.from_numpy(small[None])
    zoom = dict(out_size=(256, 256), window=(64, 64), center=(0.1, -0.2))
    with torch.inference_mode():
        xg = xs.to(device)
        gpu = count.run("decode_zoom", 3, lambda: model.decode_zoom(
            model.gen_feat(xg), xg, t[:2], **zoom).cpu().numpy())
        ref = cpu_model.decode_zoom(cpu_model.gen_feat(xs), xs,
                                    torch.tensor(times[:2]), **zoom).numpy()
    if gpu.shape != (2, 1, 64, 64, 3):
        raise AssertionError(f"decode_zoom shape {gpu.shape}")
    d = max_abs(gpu, ref)
    require("decode_zoom 64x64 of a 256x256 canvas, GPU vs CPU, max|d|", d,
            d <= WINDOW_BAR)
    del cpu_model, cpu_pipe

    log("[5e] knobs against the fp32 window (trained weights)")
    bf16, fp8 = torch.bfloat16, torch.float8_e4m3fn
    # knob -> (constructor arguments, launches per window, bar on max|d|)
    knobs = {
        "encode_splitk (plain path)": (dict(encode_splitk=True, fused=False),
                                       0, lambda d: d <= 1e-4),
        "stagec_dedup": (dict(stagec_dedup=True), 3, lambda d: d <= 1e-6),
        "gather_dtype=bfloat16": (dict(gather_dtype=bf16), 3,
                                  lambda d: 0 < d < 2e-2),
        "mlp_dtype=bfloat16": (dict(mlp_dtype=bf16), 0,
                               lambda d: 0 < d < 2e-2),
        "stagec_nearest": (dict(stagec_nearest=True), 3,
                           lambda d: 0 < d < 0.5),
        "stagec_dtype=float8_e4m3fn": (dict(stagec_dtype=fp8), 3,
                                       lambda d: 0 < d < 2e-1),
    }
    knob_pipes = {}
    for name, (kw, expect, bar) in knobs.items():
        knob_pipes[name] = (InferencePipeline(deployed_model(**kw)), expect)
        out = count.run(name, expect, lambda: knob_pipes[name][0]
                        .render_window(frames, times))
        if not np.isfinite(out).all():
            raise AssertionError(f"{name}: window not finite")
        d = max_abs(out, window)
        require(f"{name}: {expect} launches, max|d| to the fp32 window", d,
                bar(d))
        del out

    log(f"[5f] production size: LR {HD_LR_HW[0]}x{HD_LR_HW[1]} -> "
        f"{N_TIMES} x {HD_LR_HW[0] * SCALE}x{HD_LR_HW[1] * SCALE} by "
        "render_pairs (chunked)")
    hd = rng.random((1, 2) + HD_LR_HW + (3,)).astype(np.float32)
    hp = -(-HD_LR_HW[0] // pipe.bucket) * pipe.bucket  # padded LR rows
    hd_steps = -(-hp * SCALE * HD_LR_HW[1] * SCALE // CHUNK)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = count.run("render_pairs, 1080p", 3 * hd_steps,
                    lambda: pipe.render_pairs(hd, times))
    expect_shape = (1, N_TIMES, HD_LR_HW[0] * SCALE, HD_LR_HW[1] * SCALE, 3)
    if out.shape != expect_shape or not np.isfinite(out).all():
        raise AssertionError(f"1080p window: shape {out.shape}")
    del out
    t0 = time.perf_counter()
    count.run("render_pairs, 1080p", 3 * hd_steps,
              lambda: pipe.render_pairs(hd, times))
    hd_ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with torch.inference_mode():  # the encoder's share, input on the card
        xt = torch.from_numpy(pad_to_multiple(hd, 4, pipe.bucket)[0]).to(
            device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.gen_feat(xt)
        torch.cuda.synchronize()
        enc_ms = 1e3 * (time.perf_counter() - t0)
        del xt
    log(f"  {expect_shape} finite, {hd_steps} chunk steps, {3 * hd_steps} "
        f"launches: {hd_ms:.1f} ms/window (second run), of which the encoder "
        f"(gen_feat, run again alone) {enc_ms:.1f} ms; "
        f"{1e3 * N_TIMES / hd_ms:.2f} frames/s, peak memory {peak:.2f} GiB "
        f"[{card}]")

    log("[5g] quality: Y-channel PSNR on two synthetic scenes (x4, LR "
        "36x48), space-time SR protocol, trained weights")
    clips = [render_sequence(990_000 + k, 7, (144, 192)) for k in range(2)]
    n_windows = sum((c.shape[0] + 1) // 2 - 1 for c in clips)

    def psnr_by_time(p, expect, dcn="some"):
        scores = count.run("quality windows", expect * n_windows, lambda: [
            s for clip in clips for s in _score_space_time_sr(p, clip)[0]],
            dcn=dcn)
        return {tq: float(np.mean([ps for tt, ps, _ in scores if tt == tq]))
                for tq in (0.0, 0.5)}

    kernel_q = psnr_by_time(pipe, 3)
    set_fused(model, False)
    plain_q = psnr_by_time(pipe, 0)
    set_fused(model, True)
    log(f"  fp32, kernel:      PSNR t=0 {kernel_q[0.0]:.4f} dB, t=0.5 "
        f"{kernel_q[0.5]:.4f} dB")
    log(f"  fp32, plain SIREN: PSNR t=0 {plain_q[0.0]:.4f} dB, t=0.5 "
        f"{plain_q[0.5]:.4f} dB")
    for tq in (0.0, 0.5):
        if not abs(kernel_q[tq] - plain_q[tq]) <= PSNR_BAR:
            raise AssertionError(f"kernel PSNR at t={tq} is off the plain "
                                 f"SIREN's by more than {PSNR_BAR} dB")
    set_dcn_kernel(model, False)
    plain_dcn_q = psnr_by_time(pipe, 3, dcn=None)
    set_dcn_kernel(model, True)
    log(f"  fp32, plain DCN:   PSNR t=0 {plain_dcn_q[0.0]:.4f} dB, t=0.5 "
        f"{plain_dcn_q[0.5]:.4f} dB")
    for tq in (0.0, 0.5):
        if not abs(kernel_q[tq] - plain_dcn_q[tq]) <= PSNR_BAR:
            raise AssertionError(f"DCN-kernel PSNR at t={tq} is off the "
                                 f"plain DCN's by more than {PSNR_BAR} dB")
    for name, (p, expect) in knob_pipes.items():
        q = psnr_by_time(p, expect)
        log(f"  {name}: PSNR t=0 {q[0.0]:.4f} dB ({q[0.0] - kernel_q[0.0]:+.4f}"
            f"), t=0.5 {q[0.5]:.4f} dB ({q[0.5] - kernel_q[0.5]:+.4f})")
    return count


# ----------------------------------------------------------------- phase 7

ZOO_CFG = dict(nf=64, groups=8, front_RBs=5, back_RBs=40)  # full width


def zoo_fields(name, nt, Q, device):
    """One zoo net's fields laid out as its model hands them over, for nt
    query times of Q rows each: the time-independent base field broadcast
    over the time axis (row period Q), contiguous gathers, the time
    column."""
    import torch

    def r(*shape):
        return torch.rand(*shape, device=device) * 2 - 1

    splits = ZOO_NETS[name][0]
    if name == "train_feat":
        return [r(Q, 200).expand(nt, Q, 200)]
    if name == "train_flow":
        return [r(nt, Q, 128), r(Q, 200).expand(nt, Q, 200), r(nt, Q, 1)]
    if name in ("s_flow", "noflow_feat"):
        return [r(Q, 200).expand(nt, Q, 200), r(nt, Q, 1)]
    return [r(nt, Q, c) for c in splits]  # stage D: separate gathers


def zoo_kernel_phase(device, peaks) -> float:
    """Phase 7a; returns the largest max|kernel - plain|."""
    import torch
    from stif_tpu_torch.ops.siren_fused import blocks_per_sm, launch_plan

    rng = np.random.default_rng(7)
    torch.manual_seed(7)
    Q = LR_HW[0] * SCALE * LR_HW[1] * SCALE
    worst = 0.0
    total = {"kernel": 0.0, "plain": 0.0, "bound": 0.0}
    for name, (splits, widths) in ZOO_NETS.items():
        ws, bs = siren_net(rng, widths, device)
        plan = launch_plan(splits, widths)
        log(f"  {name} plan: tile widths {plan.pitch}, K-chunks {plan.kc}, "
            f"{len(plan.chunks)} first-layer chunks, {plan.smem_bytes} B "
            f"shared, {blocks_per_sm(plan)} blocks per SM")
        for nt, q in ((1, 1), (3, 63), (3, 65), (2, 4097)):
            xs = zoo_fields(name, nt, q, device)
            worst = max(worst, check(f"{name} nt={nt}", xs, ws, bs))
        xs = zoo_fields(name, N_TIMES, Q, device)
        worst = max(worst, check(name, xs, ws, bs))
        k_ms, p_ms, o_ms, y_ms = time_net(name, xs, ws, bs, peaks)
        total["kernel"] += k_ms
        total["plain"] += p_ms
        total["bound"] += max(o_ms, y_ms)
        del xs
        torch.cuda.empty_cache()
    log(f"  six zoo nets: kernel {total['kernel']:.3f} ms, plain "
        f"{total['plain']:.3f} ms, bound {total['bound']:.3f} ms")
    return worst


def seeded(build, seed: int):
    """``build()`` with its constructor's own initial distributions drawn
    under ``seed`` (the global generator is put back afterwards), then every
    DCN offset conv, which starts at zero, redrawn from a ``torch.Generator``
    of the same seed to offsets of about a pixel, so that every deformable
    conv deforms. The same seed gives the same weights."""
    import torch

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "conv_offset_mask" in name:
                fan_in = p[0].numel() if p.dim() == 4 else 1
                u = torch.rand(p.shape, generator=gen) * 2 - 1
                p.copy_(u / fan_in ** 0.5)
    return model.eval()


def on_card_and_cpu(model, device):
    """(the model on the card, an identical copy on the CPU)."""
    import copy

    return copy.deepcopy(model).to(device), model


def zoo_phase(card: str, device) -> int:
    """Phases 7b-7e. Returns the ``Launches`` of every path
    driven."""
    import tempfile

    import torch
    from stif_tpu_torch.data.synthetic import render_eval_folders
    from stif_tpu_torch.models import (LunaTokisNoFlow, LunaTokisS,
                                       LunaTokisTrain, LunaTokisZSM, TMNet)
    from stif_tpu_torch.models.ablations import _PRESETS
    from stif_tpu_torch.models.factory import define_g
    from stif_tpu_torch.nn.siren import set_fused
    from stif_tpu_torch.runtime import InferencePipeline
    from stif_tpu_torch.runtime.eval import eval_adobe_tmnet, eval_vid4_tmnet

    count = Launches()
    rng = np.random.default_rng(0)
    frames = rng.random((4,) + LR_HW + (3,)).astype(np.float32)
    small = rng.random((4, 16, 16, 3)).astype(np.float32)
    times = [i / N_TIMES for i in range(N_TIMES)]
    HH, WW = LR_HW[0] * SCALE, LR_HW[1] * SCALE
    x = torch.from_numpy(frames[None, :2]).to(device)
    xs = torch.from_numpy(small[None, :2])
    t = torch.tensor(times, device=device)

    def finite(what, out, shape):
        if tuple(out.shape) != shape or not np.isfinite(out).all():
            raise AssertionError(f"{what}: shape {tuple(out.shape)}, "
                                 f"expected {shape}, or not finite")

    log("[7b] LunaTokisTrain / S / NoFlow at full width, LR "
        f"{LR_HW[0]}x{LR_HW[1]} pair, {N_TIMES} times, x{SCALE}")
    for seed, (cls, expect) in enumerate(((LunaTokisTrain, 3),
                                          (LunaTokisS, 2),
                                          (LunaTokisNoFlow, 1))):
        name = cls.__name__
        model, cpu_model = on_card_and_cpu(
            seeded(lambda: cls(**ZOO_CFG), 70 + seed), device)
        with torch.inference_mode():
            out = count.run(name, expect,
                            lambda: model(x, t).cpu().numpy())
            finite(name, out, (N_TIMES, 1, HH, WW, 3))
            runs, peak = count.run(
                f"{name}, timed", TIMED_RUNS * expect,
                lambda: timed(lambda: model(x, t).cpu().numpy()))
            set_fused(model, False)
            t0 = time.perf_counter()
            plain = count.run(f"{name}, plain SIREN", 0,
                              lambda: model(x, t).cpu().numpy())
            plain_ms = 1e3 * (time.perf_counter() - t0)
            set_fused(model, True)
            gpu = count.run(f"{name}, 16x16", expect,
                            lambda: model(xs.to(device), t[:2]).cpu().numpy())
            ref = cpu_model(xs, t[:2].cpu()).numpy()
        log(f"  {name} {out.shape}, finite, {expect} launches: "
            f"{fmt_runs(runs)}, peak {peak:.2f} GiB; plain-SIREN forward "
            f"{plain_ms:.1f} ms [{card}]")
        d = max_abs(out, plain)
        require(f"{name}: kernel forward vs plain-SIREN forward, max|d|", d,
                d <= WINDOW_BAR)
        d = max_abs(gpu, ref)
        require(f"{name}: 16x16 window, GPU (kernel) vs CPU, max|d|", d,
                d <= WINDOW_BAR)
        del model, cpu_model, out, plain
        torch.cuda.empty_cache()

    log("[7c] LunaTokisZSM and TMNet at full width")
    model, cpu_model = on_card_and_cpu(
        seeded(lambda: LunaTokisZSM(**ZOO_CFG), 73), device)
    with torch.inference_mode():
        out = count.run("LunaTokisZSM", 0, lambda: model(x).cpu().numpy())
        finite("LunaTokisZSM", out, (1, 3, HH, WW, 3))
        runs, peak = count.run(
            "LunaTokisZSM, timed", 0,
            lambda: timed(lambda: model(x).cpu().numpy()))
        d = max_abs(model(xs.to(device)).cpu().numpy(),
                    cpu_model(xs).numpy())
    log(f"  LunaTokisZSM {out.shape}, finite, 0 launches: {fmt_runs(runs)}, "
        f"peak {peak:.2f} GiB [{card}]")
    require("LunaTokisZSM: 16x16 pair, GPU vs CPU, max|d|", d,
            d <= WINDOW_BAR)
    del model, cpu_model, out
    torch.cuda.empty_cache()

    tm_cfg = dict(ZOO_CFG, back_RBs=10)  # TMNet's own depth
    tmnet = seeded(lambda: TMNet(**tm_cfg), 74)
    pipe = InferencePipeline(tmnet, device=device)
    tm_times = [i / 6 for i in range(1, 6)]
    out = count.run("render_window_tmnet", 0,
                    lambda: pipe.render_window_tmnet(frames, tm_times))
    finite("TMNet, 4 frames and 5 times", out, (19, HH, WW, 3))
    runs, peak = count.run(
        "render_window_tmnet, timed", 0,
        lambda: timed(lambda: pipe.render_window_tmnet(frames, tm_times)))
    log(f"  TMNet render_window_tmnet, 4 frames x 5 times -> {out.shape}, "
        f"finite, 0 launches: {fmt_runs(runs)}, peak {peak:.2f} GiB [{card}]")
    x4 = torch.from_numpy(frames[None]).to(device)
    with torch.inference_mode():
        no_t = count.run("TMNet without times", 0,
                         lambda: tmnet(x4).cpu().numpy())
        finite("TMNet without times", no_t, (1, 7, HH, WW, 3))
        runs, peak = count.run(
            "TMNet without times, timed", 0,
            lambda: timed(lambda: tmnet(x4).cpu().numpy()))
    log(f"  TMNet without times, 4 frames -> {no_t.shape}, finite: "
        f"{fmt_runs(runs)}, peak {peak:.2f} GiB [{card}]")
    gpu = pipe.render_window_tmnet(small, tm_times[:2])
    cpu_pipe = InferencePipeline(seeded(lambda: TMNet(**tm_cfg), 74),
                                 device="cpu")
    d = max_abs(gpu, cpu_pipe.render_window_tmnet(small, tm_times[:2]))
    require("TMNet: 16x16 window (4 frames, 2 times), GPU vs CPU, max|d|", d,
            d <= WINDOW_BAR)
    del out, no_t, x4

    log("[7d] every LIIF_<preset> through define_g (full width, 5 + 10 "
        "blocks, LR 32x48 pair, 2 times)")
    mid = torch.from_numpy(frames[None, :2, :32, :48]).to(device)
    for k, preset in enumerate(sorted(_PRESETS)):
        opt = {"network_G": dict(which_model_G=f"LIIF_{preset}", nf=64,
                                 nframes=6, groups=8, front_RBs=5,
                                 back_RBs=10)}
        model, cpu_model = on_card_and_cpu(
            seeded(lambda: define_g(opt), 80 + k), device)
        with torch.inference_mode():
            out = count.run(f"LIIF_{preset}", 0,
                            lambda: model(mid, t[:2]).cpu().numpy())
            finite(f"LIIF_{preset}", out, (2, 1, 128, 192, 3))
            d = max_abs(model(xs.to(device), t[:2]).cpu().numpy(),
                        cpu_model(xs, t[:2].cpu()).numpy())
        require(f"LIIF_{preset}: {out.shape} finite, 0 launches; 16x16 "
                "window, GPU vs CPU, max|d|", d, d <= WINDOW_BAR)
        del model, cpu_model
    model, cpu_model = on_card_and_cpu(
        seeded(lambda: define_g({"network_G": dict(
            which_model_G="LIIF_test4", nf=64, groups=8, front_RBs=5,
            back_RBs=10)}), 90), device)
    x16 = torch.from_numpy(small[None])
    with torch.inference_mode():
        out = count.run("decode_mulfeat", 0, lambda: model(
            x16.to(device), None, mulfeat=True).cpu().numpy())
        finite("LIIF_test4 decode_mulfeat", out, (7, 1, 64, 64, 3))
        d = max_abs(out, cpu_model(x16, None, mulfeat=True).numpy())
    require("LIIF_test4 decode_mulfeat, 4 frames -> 7: GPU vs CPU, max|d|",
            d, d <= WINDOW_BAR)
    del model, cpu_model
    torch.cuda.empty_cache()

    log("[7e] eval_adobe_tmnet and eval_vid4_tmnet on rendered folders")
    with tempfile.TemporaryDirectory() as tmp:
        adobe = render_eval_folders(f"{tmp}/adobe", n_scenes=1, n_frames=19,
                                    size=(128, 192), seed0=880_000)
        vid4 = render_eval_folders(f"{tmp}/vid4", n_scenes=1, n_frames=9,
                                   size=(64, 96), seed0=881_000)
        for what, res in (
                ("eval_adobe_tmnet", count.run(
                    "eval_adobe_tmnet", 0,
                    lambda: eval_adobe_tmnet(pipe, adobe))),
                ("eval_vid4_tmnet", count.run(
                    "eval_vid4_tmnet", 0,
                    lambda: eval_vid4_tmnet(pipe, vid4)))):
            vals = [res.mean_psnr, res.mean_ssim]
            log(f"  {what} (random weights): PSNR {vals[0]:.3f} dB, SSIM "
                f"{vals[1]:.4f}, {res.avg_time_s:.2f} s")
            if not (res.psnr and np.isfinite(vals).all()):
                raise AssertionError(f"{what}: {vals}")
    return count


# ----------------------------------------------------------------- phase 8

TRAIN_BUCKETS = ((4, 48), (2, 48), (8, 24))  # (scale, LR size): GT 192, 96
WARM_STEPS, TIMED_STEPS = 2, 6
STEP_LOSS_RTOL, STEP_GNORM_RTOL = 1e-4, 1e-3  # [8c], card vs CPU
RESUME_RTOL = 1e-5                             # [8d], next loss after resume


def r5_opt(models_dir: str, val_root: str) -> dict:
    """``configs/train_synthetic_r5.yml`` as a dict (full width: LIIF, nf 64,
    groups 8, 5 + 40 blocks, ``rgb_skip`` bicubic; B 4, nt 3, its bucket
    plan, lr 1e-4, warmup 200, clip 1e6, EMA 0.999), with the validator on
    one dev scene and everything written under the given directories."""
    return {
        "name": "chip_smoke_r5", "model": "VideoSR_base", "scale": 4,
        "use_tb_logger": True,
        "datasets": {
            "train": {
                "mode": "Synthetic", "n_items": 20000, "nt": 3, "seed": 55,
                "interval_choices": [2, 2, 4], "n_workers": 2,
                "batch_size": 4, "GT_size": 192,
                "scale_plan": [[2, 48], [3, 48], [4, 48], [4, 48], [4, 48],
                               [6, 32], [8, 24]],
                "natural_frac": 0.25},
            "val": {"n_scenes": 1, "root": val_root, "scale_probes": []}},
        "network_G": {"which_model_G": "LIIF", "nf": 64, "nframes": 6,
                      "groups": 8, "front_RBs": 5, "back_RBs": 40,
                      "rgb_skip": "bicubic"},
        "path": {"models": models_dir},
        "train": {
            "lr_G": 1e-4, "beta1": 0.9, "beta2": 0.99, "niter": 27000,
            "warmup_iter": 200,
            "T_period": [3000, 3000, 4000, 5000, 6000, 6000],
            "restarts": [3000, 6000, 10000, 15000, 21000],
            "restart_weights": [0.75, 0.55, 0.42, 0.32, 0.25],
            "eta_min": 1e-7, "pixel_criterion": "cb", "pixel_weight": 1.0,
            "grad_clip": 1e6, "ema_decay": 0.999, "val_freq": 500},
        "logger": {"print_freq": 50, "save_checkpoint_freq": 500},
    }


def with_buckets(opt: dict, plan) -> dict:
    import copy

    out = copy.deepcopy(opt)
    out["datasets"]["train"]["scale_plan"] = [list(b) for b in plan]
    return out


def batches(opt: dict):
    """The train script's loader over ``create_train_dataset(opt)``: a
    generator of batches (close it to stop the loader's thread)."""
    from stif_tpu_torch.data.datasets import create_train_dataset
    from stif_tpu_torch.data.loader import DataLoader, ShardedIterSampler

    ds, collate = create_train_dataset(opt)
    dopt = opt["datasets"]["train"]
    return DataLoader(ds, batch_size=dopt["batch_size"], collate=collate,
                      sampler=ShardedIterSampler(len(ds), ratio=100)
                      ).epoch(0)


def timed_step(model):
    """One ``optimize_parameters`` with CUDA events at its phases: (logs,
    {forward, backward, update, step} ms). 'update' is the optimizer and
    the EMA; the step ends once its logs are on the host."""
    import torch

    ev = {k: torch.cuda.Event(enable_timing=True)
          for k in ("start", "forward", "backward", "end")}
    ev["start"].record()
    logs = model.optimize_parameters(
        mark=lambda name: ev[name].record() if name in ev else None)
    ev["end"].record()
    ev["end"].synchronize()
    return logs, {"forward": ev["start"].elapsed_time(ev["forward"]),
                  "backward": ev["forward"].elapsed_time(ev["backward"]),
                  "update": ev["backward"].elapsed_time(ev["end"]),
                  "step": ev["start"].elapsed_time(ev["end"])}


def train_speed(opt: dict, card: str) -> None:
    """[8a]: train steps at each of ``TRAIN_BUCKETS``, timed."""
    import torch
    from stif_tpu_torch.data.natural import find_natural_textures
    from stif_tpu_torch.train.video_sr_model import VideoSRModel

    n = len(find_natural_textures())
    log(f"  bundled photographs found: {n}" + (
        "" if n else " (the natural_frac samples are procedural scenes)"))
    model = VideoSRModel(opt)
    for bucket in TRAIN_BUCKETS:
        gen = batches(with_buckets(opt, [bucket]))
        if model.optimizer is None:  # init from the first batch
            first = next(gen)
            model.init_params(first["LQs"], first["times"], seed=0)
            n = sum(p.numel() for p in model.net.parameters())
            log(f"  init_model_ (seed 0): {n} parameters")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rows, walls = [], []
        for i in range(WARM_STEPS + TIMED_STEPS):
            batch = next(gen)
            t0 = time.perf_counter()
            model.feed_data(batch)
            logs, ms = timed_step(model)
            wall = 1e3 * (time.perf_counter() - t0)
            s, g = batch["scale"], batch["GT"].shape[2]
            log(f"  step {model.step:3d} x{s} GT {g}x{g} B {len(batch['GT'])}"
                f" nt {batch['GT'].shape[1]}: loss {logs['loss']:.2f}, grad "
                f"norm {logs['grad_norm']:.1f}, {ms['step']:.1f} ms "
                f"(wall {wall:.1f})" + ("  [warm-up]" if i < WARM_STEPS
                                        else ""))
            if not (np.isfinite(logs["loss"]) and
                    np.isfinite(logs["grad_norm"])):
                raise AssertionError(f"step {model.step}: not finite")
            if i >= WARM_STEPS:
                rows.append(ms)
                walls.append(wall)
        peak = torch.cuda.max_memory_allocated() / 2**30
        step = [r["step"] for r in rows]
        med = {k: float(np.median([r[k] for r in rows])) for k in rows[0]}
        B = batch["GT"].shape[0]
        log(f"  x{bucket[0]} bucket (LR {bucket[1]}, GT {batch['GT'].shape[2]}"
            f"), {TIMED_STEPS} steps: {med['step']:.1f} ms/step median "
            f"(min {min(step):.1f}, max {max(step):.1f}); forward "
            f"{med['forward']:.1f}, backward {med['backward']:.1f}, "
            f"optimizer + EMA {med['update']:.1f} ms; "
            f"{1e3 * B / med['step']:.2f} samples/s; host wall "
            f"{np.median(walls):.1f} ms/step; peak {peak:.2f} GiB [{card}]")
        if bucket == TRAIN_BUCKETS[0]:  # one profiled step at x4
            model.feed_data(next(gen))
            device_profile(model.optimize_parameters,
                           float(np.median(walls)), "x4 train step", card,
                           top=15)
        gen.close()


def train_phase(card: str, device) -> int:
    """Phases 8a-8f. Returns the ``Launches`` of every path
    driven."""
    import copy
    import importlib.util
    import logging
    import tempfile
    from argparse import Namespace

    import torch
    from stif_tpu_torch.data.synthetic import SyntheticVideoDataset
    from stif_tpu_torch.nn.siren import set_fused
    from stif_tpu_torch.train.validation import BestTracker, Validator
    from stif_tpu_torch.train.video_sr_model import VideoSRModel

    count = Launches()
    torch.cuda.empty_cache()
    tmp = tempfile.TemporaryDirectory()
    opt = r5_opt(f"{tmp.name}/models", f"{tmp.name}/val")

    log("[8a] train steps at the r5 config's full width: ms, split, "
        "samples/s, peak, profile")
    count.run("train steps", 0, lambda: train_speed(opt, card))
    n_steps = len(TRAIN_BUCKETS) * (WARM_STEPS + TIMED_STEPS) + 1
    fwd, bwd = count.last
    log(f"  DCN launches in {n_steps} steps: {fwd} dcn_forward, {bwd} "
        "dcn_backward")
    if (fwd, bwd) != (DCN_STEP_FORWARD * n_steps, DCN_PER_PAIR * n_steps):
        raise AssertionError(f"DCN launches ({fwd}, {bwd}) in {n_steps} "
                             f"train steps, expected {DCN_STEP_FORWARD} "
                             f"forward and {DCN_PER_PAIR} backward a step")
    torch.cuda.empty_cache()

    log("[8b] ten steps on one fixed x4 batch, warmup off: the loss falls")
    fixed = copy.deepcopy(opt)
    fixed["train"]["warmup_iter"] = -1
    gen = batches(with_buckets(fixed, [TRAIN_BUCKETS[0]]))
    batch = next(gen)
    gen.close()
    model = VideoSRModel(fixed)
    model.init_params(batch["LQs"], batch["times"], seed=0)
    model.feed_data(batch)
    steps = count.run("fixed batch", 0,
                      lambda: [timed_step(model) for _ in range(10)])
    losses = [logs["loss"] for logs, _ in steps]
    log("  losses " + ", ".join(f"{v:.2f}" for v in losses))
    log(f"  {float(np.median([ms['step'] for _, ms in steps[2:]])):.1f} ms "
        "per step median of steps 3-10, no loader thread running "
        f"[{card}]")
    require("last loss / first loss", losses[-1] / losses[0],
            losses[-1] < losses[0])

    log("[8c] one train step from the same init on the card and on the CPU "
        "(full width, B 1, LR 16x16, GT 64x64, nt 2; TF32 off)")
    small = SyntheticVideoDataset(n_items=10, gt_size=64, scale=4, nt=2,
                                  seed=55)[0]
    one = {k: (v[None] if k != "key" else v) for k, v in small.items()}
    logs, grads = [], []
    for dev in (device, "cpu"):
        m = VideoSRModel(fixed, device=dev)
        m.init_params(one["LQs"], one["times"], seed=0)
        m.feed_data(one)
        t0 = time.perf_counter()
        logs.append(count.run(f"train step on {dev}", 0,
                              m.optimize_parameters,
                              dcn=None if dev == "cpu" else "some"))
        log(f"  {dev}: loss {logs[-1]['loss']:.6f}, grad norm "
            f"{logs[-1]['grad_norm']:.4f}, {time.perf_counter() - t0:.2f} s; "
            f"DCN launches (forward, backward) {count.last}")
        if dev != "cpu" and count.last != (DCN_STEP_FORWARD, DCN_PER_PAIR):
            raise AssertionError(f"DCN launches {count.last} in one step, "
                                 f"expected ({DCN_STEP_FORWARD}, "
                                 f"{DCN_PER_PAIR})")
        grads.append({n: p.grad.cpu() for n, p in m.net.named_parameters()
                      if p.grad is not None})
        del m
    (gpu, cpu) = logs
    d = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    require("loss, card vs CPU, relative", d, d <= STEP_LOSS_RTOL)
    d = abs(gpu["grad_norm"] - cpu["grad_norm"]) / abs(cpu["grad_norm"])
    require("grad norm, card vs CPU, relative", d, d <= STEP_GNORM_RTOL)
    worst = max(((n, (grads[0][n] - g).abs().max().item(),
                  g.abs().max().item()) for n, g in grads[1].items()),
                key=lambda r: r[1] / max(r[2], 1e-30))
    log(f"  largest per-parameter gradient difference (relative to the "
        f"parameter's largest gradient): {worst[0]}: {worst[1]:.3e} of "
        f"{worst[2]:.3e}")
    torch.cuda.empty_cache()

    log("[8d] save after 10 steps, resume into a fresh VideoSRModel")
    model.save()
    saved = train_state(model)
    loss_next = model.optimize_parameters()["loss"]
    fresh = VideoSRModel(fixed)
    fresh.init_params(batch["LQs"], batch["times"], seed=1)
    if fresh.resume_training() != 10:
        raise AssertionError("resume did not return step 10")
    mismatch = compare_states(train_state(fresh), saved)
    if mismatch:
        raise AssertionError(f"resumed state differs from the saved one: "
                             f"{mismatch[:5]}")
    log(f"  params, Adam moments ({len(saved['moments'])} tensors' "
        "states), step and EMA bitwise equal to the saved ones")
    fresh.feed_data(batch)
    resumed = fresh.optimize_parameters()["loss"]
    d = abs(resumed - loss_next) / abs(loss_next)
    require(f"step 11 loss resumed {resumed:.4f} vs uninterrupted "
            f"{loss_next:.4f}, relative difference", d, d <= RESUME_RTOL)
    del fresh, saved
    torch.cuda.empty_cache()

    log("[8e] validation probe through the kernel vs the plain SIREN "
        "(1 dev scene, 144x192), keep-best, eval_model_torch --best")
    validator = Validator(model.net, root=f"{tmp.name}/val", n_scenes=1)
    windows = 5  # 12 frames: input pairs (0, 2) ... (8, 10)
    params = model.net.state_dict()
    m_kernel = count.run("validation probe", 3 * windows,
                         lambda: validator.validate(params))
    set_fused(validator.net, False)
    m_plain = count.run("validation probe, plain SIREN", 0,
                        lambda: validator.validate(params))
    set_fused(validator.net, True)
    for key in ("t0_psnr", "t05_psnr"):
        d = abs(m_kernel[key] - m_plain[key])
        require(f"{key} kernel {m_kernel[key]:.4f} vs plain "
                f"{m_plain[key]:.4f} dB, |d|", d, d <= PSNR_BAR)
    best = BestTracker(f"{tmp.name}/models")
    if not best.update(model.step, m_kernel, params):
        raise AssertionError("the first probe was not kept as best")
    spec = importlib.util.spec_from_file_location(
        "eval_model_torch", ROOT / "scripts" / "eval_model_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    args = Namespace(pth=None, best=True, step=None)
    net = copy.deepcopy(validator.net).cpu()
    script.load_weights(net, args, opt)
    same = all(torch.equal(a.cpu(), b) for a, b in
               zip(params.values(), net.state_dict().values()))
    if args.ckpt_step != model.step or not same:
        raise AssertionError("eval_model_torch --best did not read back "
                             "the keep-best weights")
    log(f"  best.json step {args.ckpt_step} read back by eval_model_torch "
        "--best: weights bitwise equal")
    del validator, model, net, params
    torch.cuda.empty_cache()

    log("[8f] scripts/train_torch.py run(): 20 steps (val and checkpoints "
        "every 10), then resume to 25")
    spec = importlib.util.spec_from_file_location(
        "train_torch", ROOT / "scripts" / "train_torch.py")
    train_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(train_script)
    run_opt = r5_opt(f"{tmp.name}/run", f"{tmp.name}/val")
    run_opt["train"]["val_freq"] = 10
    run_opt["logger"].update(print_freq=5, save_checkpoint_freq=10)
    logging.getLogger("base").setLevel(logging.INFO)
    # probes (raw and EMA each): 0, 10, 20; after resuming, 25
    t0 = time.perf_counter()
    last = count.run("train_torch.run, 20 steps", 3 * windows * 6,
                     lambda: train_script.run(run_opt, steps=20))
    t1 = time.perf_counter()
    last2 = count.run("train_torch.run, resume to 25", 3 * windows * 2,
                      lambda: train_script.run(run_opt, steps=25,
                                               resume=True))
    t2 = time.perf_counter()
    text = Path(f"{tmp.name}/run/train.log").read_text()
    curve = [json.loads(line)["step"] for line in
             Path(f"{tmp.name}/run/val_curve.jsonl").read_text().splitlines()]
    if (last, last2) != (20, 25) or "resumed at step 20" not in text \
            or curve != [0, 10, 20, 25]:
        raise AssertionError(f"train script: ended at {last}, {last2}; "
                             f"probes at {curve}")
    log(f"  run 1: steps 1-20 in {t1 - t0:.1f} s; run 2 resumed at step 20, "
        f"ended at 25 in {t2 - t1:.1f} s (validation, init and checkpoints "
        f"included); probes at steps {curve}")
    for line in text.splitlines():
        if " step " in line or "val @" in line:
            log("    " + line.split(" INFO ")[-1])
    tmp.cleanup()
    return count


# ----------------------------------------------------------------- phase 9

DDP_LOSS_RTOL, DDP_GNORM_RTOL = 1e-5, 1e-4   # [9a], DDP vs one process
MESH_BAR = 1e-5                               # [9c], [9e]
SEQ_FRAMES = 5                                # [9d]: 4 pairs


def ddp_phase(opt: dict, card: str) -> None:
    """[9a]: the data-parallel step at world size 1 over NCCL against the
    single-process step from the same init, then both timed."""
    import torch
    import torch.distributed as dist
    from stif_tpu_torch.parallel.distributed import free_port
    from stif_tpu_torch.train.video_sr_model import VideoSRModel

    fixed = with_buckets(opt, [TRAIN_BUCKETS[0]])
    gen = batches(fixed)
    data = [next(gen) for _ in range(3)]
    gen.close()
    port = free_port()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        models = {}
        for name, parallel in (("ddp", True), ("one", False)):
            m = VideoSRModel(fixed, parallel=parallel)
            m.init_params(data[0]["LQs"], data[0]["times"], seed=0)
            models[name] = m
        for i, batch in enumerate(data):
            logs = {}
            for name, m in models.items():
                m.feed_data(batch)
                logs[name] = m.optimize_parameters()
            d_loss = abs(logs["ddp"]["loss"] - logs["one"]["loss"]) / abs(
                logs["one"]["loss"])
            d_norm = abs(logs["ddp"]["grad_norm"] - logs["one"]["grad_norm"]
                         ) / abs(logs["one"]["grad_norm"])
            log(f"  step {i + 1}: loss {logs['ddp']['loss']:.4f} (DDP) / "
                f"{logs['one']['loss']:.4f}, grad norm "
                f"{logs['ddp']['grad_norm']:.2f} / "
                f"{logs['one']['grad_norm']:.2f}")
            require("loss, DDP vs one process, relative", d_loss,
                    d_loss <= DDP_LOSS_RTOL)
            require("grad norm, DDP vs one process, relative", d_norm,
                    d_norm <= DDP_GNORM_RTOL)
        a = models["ddp"].net.state_dict()
        worst = max(((k, (a[k] - v).abs().max().item()) for k, v in
                     models["one"].net.state_dict().items()),
                    key=lambda r: r[1])
        log(f"  largest per-parameter gap after step 3: {worst[0]}: "
            f"{worst[1]:.3e}")
        ms = {"ddp": [], "one": []}
        for _ in range(5):
            for name, m in models.items():
                m.feed_data(data[0])
                ms[name].append(timed_step(m)[1]["step"])
        log(f"  ms per step, median of 5 alternating, x4 bucket B 4: DDP "
            f"{np.median(ms['ddp']):.1f} (runs "
            f"{', '.join(f'{v:.1f}' for v in ms['ddp'])}), one process "
            f"{np.median(ms['one']):.1f} (runs "
            f"{', '.join(f'{v:.1f}' for v in ms['one'])}) [{card}]")
    finally:
        dist.destroy_process_group()
    del models
    torch.cuda.empty_cache()


def torchrun_phase(opt: dict, tmp: str, card: str) -> None:
    """[9b]: ``scripts/train_torch.py --parallel`` under
    ``torch.distributed.run`` for 6 steps (checkpoint at 5), then resumed
    without ``--parallel`` to 8."""
    import copy
    import os

    from stif_tpu_torch.parallel.distributed import free_port

    run_opt = copy.deepcopy(with_buckets(opt, [TRAIN_BUCKETS[0]]))
    run_opt["path"]["models"] = f"{tmp}/torchrun"
    run_opt["train"]["val_freq"] = 0
    run_opt["use_tb_logger"] = False
    run_opt["logger"].update(print_freq=1, save_checkpoint_freq=5)
    cfg = Path(tmp) / "torchrun.json"
    cfg.write_text(json.dumps(run_opt))
    script = str(ROOT / "scripts" / "train_torch.py")
    cmds = [
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "1", "--master_addr", "localhost", "--master_port",
         str(free_port()), script, "--parallel", "-opt", str(cfg),
         "--steps", "6"],
        [sys.executable, script, "-opt", str(cfg), "--steps", "8",
         "--resume"]]
    for what, cmd in zip(("torch.distributed.run ... --parallel, 6 steps",
                          "resumed without --parallel to 8"), cmds):
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=300, env=dict(os.environ))
        if out.returncode != 0:
            raise AssertionError(f"{what}: exit {out.returncode}\n"
                                 f"{out.stderr[-4000:]}")
        log(f"  {what}: exit 0 in {time.perf_counter() - t0:.1f} s [{card}]")
    text = (Path(tmp) / "torchrun" / "train.log").read_text()
    for want in ("checkpoint @ 5", "done at step 6", "resumed at step 6",
                 "done at step 8"):
        if want not in text:
            raise AssertionError(f"train.log lacks '{want}'")
    for line in text.splitlines():
        if " step " in line:
            log("    " + line.split(" INFO ")[-1])


def parallel_phase(card: str, device) -> int:
    """Phases 9a-9e. Returns the ``Launches`` of every path
    driven."""
    import tempfile

    import torch
    from stif_tpu_torch.data import native
    from stif_tpu_torch.data.datasets import host_imresize
    from stif_tpu_torch.ops import backward_warp, warp_grid_coords
    from stif_tpu_torch.ops.psroi_pool import deform_psroi_pool
    from stif_tpu_torch.parallel import default_mesh, make_mesh
    from stif_tpu_torch.runtime import ChunkedDecoder, InferencePipeline

    count = Launches()
    torch.cuda.empty_cache()
    tmp = tempfile.TemporaryDirectory()
    opt = r5_opt(f"{tmp.name}/models", f"{tmp.name}/val")

    log("[9a] data-parallel train step (DDP, NCCL, world size 1) vs one "
        "process, r5 config at full width, x4 bucket (B 4, LR 48, GT 192, "
        "nt 3), seed-0 weights, 3 steps")
    count.run("DDP train steps", 0, lambda: ddp_phase(opt, card))

    log("[9b] scripts/train_torch.py --parallel under torch.distributed.run")
    torchrun_phase(opt, tmp.name, card)

    log("[9c] ChunkedDecoder over a mesh of two handles of cuda:0 (n_par 2) "
        f"vs one device, trained weights, LR {LR_HW[0]}x{LR_HW[1]}, "
        f"{N_TIMES} times, x{SCALE}, chunk {CHUNK}")
    model = deployed_model().to(device).eval()
    rng = np.random.default_rng(0)
    frames = rng.random((SEQ_FRAMES,) + LR_HW + (3,)).astype(np.float32)
    times = [i / N_TIMES for i in range(N_TIMES)]
    HH, WW = LR_HW[0] * SCALE, LR_HW[1] * SCALE
    x = torch.from_numpy(frames[None, :2]).to(device)
    t = torch.tensor(times, device=device)
    with torch.inference_mode():
        feat = model.gen_feat(x)
    steps = -(-HH * WW // CHUNK)
    one = ChunkedDecoder(model, CHUNK)
    mesh = make_mesh({"model": 2}, [torch.device("cuda", 0)] * 2)
    two = ChunkedDecoder(model, CHUNK, mesh=mesh)
    if two.n_par != 2:
        raise AssertionError(f"n_par {two.n_par}")
    want = count.run("ChunkedDecoder, one device", 3 * steps,
                     lambda: one.decode(feat, x, t, (HH, WW)), dcn=None)
    C = min(CHUNK, -(-HH * WW // 2))
    mesh_chunks = 2 * -(-HH * WW // (2 * C))
    got = count.run("ChunkedDecoder, mesh n_par 2", 3 * mesh_chunks,
                    lambda: two.decode(feat, x, t, (HH, WW)), dcn=None)
    d = max_abs(got, want)
    require(f"mesh ({mesh_chunks // 2} steps of 2 x {C} queries) vs one "
            "device, max|d|", d, d <= MESH_BAR)
    size1 = ChunkedDecoder(model, CHUNK, mesh=default_mesh())
    same = count.run("ChunkedDecoder, default_mesh() of size 1", 3 * steps,
                     lambda: size1.decode(feat, x, t, (HH, WW)), dcn=None)
    if size1.n_par != 1 or not np.array_equal(same, want):
        raise AssertionError("a mesh of size 1 differs from no mesh")
    log("  default_mesh() (size 1) output bitwise equal to no mesh")
    runs, peak = count.run(
        "ChunkedDecoder mesh, timed", TIMED_RUNS * 3 * mesh_chunks,
        lambda: timed(lambda: two.decode(feat, x, t, (HH, WW))), dcn=None)
    runs1, _ = count.run(
        "ChunkedDecoder one device, timed", TIMED_RUNS * 3 * steps,
        lambda: timed(lambda: one.decode(feat, x, t, (HH, WW))), dcn=None)
    log(f"  mesh n_par 2 {fmt_runs(runs)}, peak {peak:.2f} GiB; one device "
        f"{fmt_runs(runs1)} [{card}]")
    del feat, one, two, size1

    log(f"[9d] render_sequence, {SEQ_FRAMES} frames ({SEQ_FRAMES - 1} "
        f"pairs) at LR {LR_HW[0]}x{LR_HW[1]}, {N_TIMES} times, x{SCALE}: "
        "double-buffered vs back to back")
    pipe = InferencePipeline(model)
    pairs = SEQ_FRAMES - 1

    def back_to_back():
        return [pipe.render_window(frames[i:i + 2], times)
                for i in range(pairs)]

    seq = count.run("render_sequence", 3 * pairs,
                    lambda: pipe.render_sequence(frames, N_TIMES))
    ref = count.run("render_window x 4", 3 * pairs, back_to_back)
    if len(seq) != pairs or not all(np.array_equal(a, b)
                                    for a, b in zip(seq, ref)):
        raise AssertionError("render_sequence differs from the windows")
    log(f"  {pairs} pairs, each {seq[0].shape}, bitwise equal to "
        f"render_window back to back; {3 * pairs} launches each way")
    ms = {"double-buffered": [], "back to back": []}
    for _ in range(3):
        for name, fn in (("double-buffered",
                          lambda: pipe.render_sequence(frames, N_TIMES)),
                         ("back to back", back_to_back)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            count.run(name, 3 * pairs, fn)
            ms[name].append(1e3 * (time.perf_counter() - t0) / pairs)
    log("  ms per pair, 3 alternating runs: " + "; ".join(
        f"{k} min {min(v):.1f}, median {np.median(v):.1f} (runs "
        f"{', '.join(f'{r:.1f}' for r in v)})" for k, v in ms.items())
        + f" [{card}]")
    del pipe, model, seq, ref
    torch.cuda.empty_cache()

    log("[9e] warp ops, the native resize, deform_psroi_pool: card vs CPU")
    g = torch.Generator().manual_seed(9)
    # a smooth 64-channel field (a few cycles across the frame, as warped
    # features and frames are): the card's and the CPU's bilinear weights
    # differ by an ulp of the pixel coordinate (6.1e-5 at 512-1023 px), so
    # on white noise the two differ by up to that much; reported beside
    yy, xx = torch.meshgrid(torch.linspace(0, 1, HH), torch.linspace(0, 1, WW),
                            indexing="ij")
    fx, fy, ph = (torch.rand(3, 64, generator=g) * torch.tensor(
        [[3.0], [2.0], [6.283]]))
    img = 0.5 + 0.5 * torch.sin(xx[..., None] * fx * 6.283
                                + yy[..., None] * fy * 6.283 + ph)[None]
    noise = torch.rand(1, HH, WW, 64, generator=g)
    flow = torch.randn(1, HH, WW, 2, generator=g) * 5
    d_warp, d_noise = (max_abs(backward_warp(v.to(device),
                                             flow.to(device)).cpu(),
                               backward_warp(v, flow)) for v in (img, noise))
    coords = torch.rand(1, HH * WW, 2, generator=g) * 2 - 1
    qflow = torch.randn(1, HH * WW, 2, generator=g) * 5
    d_coords = max_abs(warp_grid_coords(coords.to(device), qflow.to(device),
                                        HH, WW).cpu(),
                       warp_grid_coords(coords, qflow, HH, WW))
    frame = np.random.default_rng(3).random((1080, 1920, 3)).astype(
        np.float32)
    t0 = time.perf_counter()
    native.host_imresize(frame, 0.25)  # builds the library on first use
    log(f"  native library ready in {time.perf_counter() - t0:.2f} s, "
        f"{native.num_threads()} threads")
    res = {}
    for name, fn in (("native", native.host_imresize),
                     ("plain", host_imresize)):
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            res[name] = fn(frame, 0.25)
            runs.append(1e3 * (time.perf_counter() - t0))
        res[name + "_ms"] = runs
    d_native = max_abs(res["native"], res["plain"])
    log(f"  ms per 1080p frame (x1/4): native {min(res['native_ms']):.1f} "
        f"(runs {', '.join(f'{v:.1f}' for v in res['native_ms'])}), plain "
        f"{min(res['plain_ms']):.1f} (runs "
        f"{', '.join(f'{v:.1f}' for v in res['plain_ms'])}) [{card}]")
    G, P, O = 7, 7, 8
    feats = torch.randn(2, 64, 64, O * G * G, generator=g)
    lo = torch.rand(32, 2, generator=g) * 40
    rois = torch.cat([torch.randint(0, 2, (32, 1), generator=g).float(), lo,
                      lo + 4 + torch.rand(32, 2, generator=g) * 20], 1)
    trans = torch.randn(32, 1, 2, P, P, generator=g)
    kw = dict(pooled_size=P, output_dim=O, group_size=G, sample_per_part=4,
              trans_std=0.1, spatial_scale=0.5)
    got, gcnt = deform_psroi_pool(feats.to(device), rois.to(device),
                                  trans.to(device), **kw)
    want, wcnt = deform_psroi_pool(feats, rois, trans, **kw)
    d_psroi = max_abs(got.cpu(), want)
    log(f"  backward_warp on white noise (no bar), max|d|: {d_noise:.3e}")
    require(f"backward_warp (1, {HH}, {WW}, 64), smooth field, max|d|",
            d_warp, d_warp <= MESH_BAR)
    require(f"warp_grid_coords ({HH * WW} queries), max|d|", d_coords,
            d_coords <= MESH_BAR)
    require("native host_imresize vs plain, 1080x1920 -> 270x480, max|d|",
            d_native, d_native <= MESH_BAR)
    require("deform_psroi_pool (32 rois, 7x7 bins, 392 channels), max|d|",
            d_psroi, d_psroi <= MESH_BAR and torch.equal(gcnt.cpu(), wcnt))
    tmp.cleanup()
    return count


# ---------------------------------------------------------------- phase 10

LSB = 1  # [10]: uint8 frames of two batchings of the same pairs


def lsb_diff(a, b) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {a.shape} vs {b.shape}")
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def bench_phase(card: str, device) -> Launches:
    """Phase 10. Returns the ``Launches`` of every path driven."""
    import torch
    from stif_tpu_torch.runtime import bench, profile

    count = Launches()
    torch.cuda.empty_cache()
    model = bench.build(device, WEIGHTS, bench.Knobs())
    times = bench.times_for(N_TIMES)
    groups = bench.draw_pairs(np.random.default_rng(10), 2, LR_HW, 2)
    pairs = groups.reshape((-1,) + groups.shape[2:])
    windows = bench.WARMUP + len(pairs)
    calls = bench.WARMUP + len(groups)  # batched calls, warm-up included
    HH, WW = LR_HW[0] * SCALE, LR_HW[1] * SCALE
    steps = -(-HH * WW // CHUNK)

    log(f"[10] bench: b1 over {len(pairs)} pairs, batched over "
        f"{len(groups)} x 2 of the same pairs (full, chunk {CHUNK}), "
        f"LR {LR_HW[0]}x{LR_HW[1]}, {N_TIMES} times, trained weights")
    b1 = count.run("bench_b1", 3 * windows,
                   lambda: bench.bench_b1(model, pairs, times),
                   dcn=(DCN_PER_PAIR * windows, 0))
    if (b1["siren_launches"], b1["dcn_launches"]) != (3, DCN_PER_PAIR):
        raise AssertionError(f"b1 launches per window "
                             f"{b1['siren_launches']}, {b1['dcn_launches']}")
    full = count.run("bench_batched full", 3 * calls,
                     lambda: bench.bench_batched(model, groups, times),
                     dcn=(DCN_PER_PAIR * calls, 0))
    chunked = count.run(
        f"bench_batched chunk {CHUNK}", 3 * steps * calls,
        lambda: bench.bench_batched(model, groups, times, str(CHUNK)),
        dcn=(DCN_PER_PAIR * calls, 0))
    d_b1 = max(lsb_diff(g[:, j], b1["outs"][2 * i + j])
               for i, g in enumerate(full["outs"]) for j in range(2))
    d_chunk = max(lsb_diff(a, b)
                  for a, b in zip(chunked["outs"], full["outs"]))
    require("batched (full) uint8 frames vs b1 of the same pairs, max|d| "
            "in LSB", d_b1, d_b1 <= LSB)
    require("batched chunked vs full uint8 frames, max|d| in LSB", d_chunk,
            d_chunk <= LSB)
    flops = bench.window_flops(model, 1, N_TIMES, (HH, WW))
    peak = bench.fp32_peak(device)
    mfu = flops / b1["window_s"] / peak[1]
    require(f"mfu ({flops / 1e12:.4f} TFLOP per window over "
            f"{1e3 * b1['window_s']:.1f} ms, {peak[0]} fp32 peak "
            f"{peak[1] / 1e12:.0f} TFLOP/s)", mfu, 0 < mfu <= 1)
    dev_ms = b1["window_device_ms"]
    log(f"  b1 {b1['fps']:.3f} frames/s ({1e3 * b1['window_s']:.1f} ms per "
        f"window; device span per window "
        f"{', '.join(f'{v:.1f}' for v in dev_ms)} ms), peak "
        f"{b1['peak_gib']:.2f} GiB; 3 SIREN and {DCN_PER_PAIR} dcn_forward "
        f"launches per window; batched full {full['fps']:.3f} frames/s, "
        f"peak {full['peak_gib']:.2f} GiB; chunked {chunked['fps']:.3f} "
        f"frames/s, peak {chunked['peak_gib']:.2f} GiB [{card}]")
    del model, b1, full, chunked
    torch.cuda.empty_cache()

    log("[10] scripts/bench_torch.py as a subprocess")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "scripts/bench_torch.py"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"bench_torch.py exit {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    line = out.stdout.strip().splitlines()[-1]
    rec = json.loads(line)
    if rec["metric"] != "frames_per_sec" or not rec["value"] > 0:
        raise AssertionError(f"bench_torch.py line: {line[:300]}")
    log(f"  exit 0 in {time.perf_counter() - t0:.1f} s: {line}")

    log("[10] profile of one streamed b1 window (runtime/profile.py)")
    # the unprofiled stream (2 warm-up and 5 windows), the stage split (3
    # encodes and 3 decodes) and the capture (a warm-up and 3 windows)
    n = bench.WARMUP + bench.ITERS + 3 + 4
    prof = count.run("profile", 3 * n,
                     lambda: profile.run(device, bench.Knobs()),
                     dcn=(DCN_PER_PAIR * n, 0))
    log(f"  {json.dumps(prof)}")
    return count


def train_state(model) -> dict:
    """What a resume must restore: step, params, Adam moments, EMA (copies
    on the card)."""
    opt = model.optimizer.state_dict()
    return {"step": model.step,
            "params": {k: v.clone() for k, v in
                       model.net.state_dict().items()},
            "moments": {i: {k: v.clone() for k, v in s.items()}
                        for i, s in opt["state"].items()},
            "ema": {k: v.clone() for k, v in model.ema_params.items()}}


def compare_states(a: dict, b: dict) -> list:
    """Names of the entries of two ``train_state``s that are not bitwise
    equal."""
    import torch

    bad = [] if a["step"] == b["step"] else ["step"]
    for key in ("params", "ema"):
        bad += [f"{key}.{k}" for k in b[key]
                if k not in a[key] or not torch.equal(a[key][k], b[key][k])]
    for i, s in b["moments"].items():
        bad += [f"moments.{i}.{k}" for k, v in s.items()
                if not torch.equal(a["moments"].get(i, {}).get(k), v)]
    return bad


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

    from stif_tpu_torch.runtime.bench import card_line, card_model

    t_start = time.perf_counter()
    device = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    peaks = PEAKS[card_model(name).split()[-1]]
    log(f"[1] device: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("    TF32 off: cudnn.allow_tf32 = False, cuda.matmul.allow_tf32 = "
        "False (fp32 parity)")

    t0 = time.perf_counter()
    logs = cuda_build.build(["siren_fused", "deform_conv"])
    log(f"[2] build: {time.perf_counter() - t0:.1f} s")
    for kname, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {kname}: {line.strip()}")

    log("[3] kernels vs plain, then timed at the main path's shapes")
    err, ms, plain_ms, bound_ms, bound_by = kernel_phase(device, peaks)
    torch.cuda.synchronize()
    log("[3b] DCN kernels vs plain at the encoder's shapes (trained, +-6 px "
        "and zero offsets, stride 2, dilation 2, shift_bound 2), then timed")
    dcn = dcn_kernel_phase(device, peaks, card)
    if "--kernels" in sys.argv[1:]:
        log("[5a] kernel vs plain at the chunked stages' shapes")
        err = max(err, slice_kernel_checks(device))
        log("[7a] kernel vs plain at the model zoo's six nets, then timed")
        err = max(err, zoo_kernel_phase(device, peaks))
        log(f"    kernels: max|d| {err:.3e}, {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms [{card}]")
        return 0

    log("[4] main path: InferencePipeline.render_window, trained weights")
    launches = main_path(card)
    dcn_launches = [DCN_PER_PAIR * 4, 0]  # main_path's four counted windows

    def add(count):
        dcn_launches[0] += count.dcn[0]
        dcn_launches[1] += count.dcn[1]
        return count.total

    log("[5a] kernel vs plain at the chunked stages' shapes")
    err = max(err, slice_kernel_checks(device))
    launches += add(slice_phase(card, device))

    log("[7a] kernel vs plain at the model zoo's six nets, then timed")
    err = max(err, zoo_kernel_phase(device, peaks))
    launches += add(zoo_phase(card, device))

    launches += add(train_phase(card, device))

    t9 = time.perf_counter()
    launches += add(parallel_phase(card, device))
    log(f"    phase 9: {time.perf_counter() - t9:.1f} s")

    t10 = time.perf_counter()
    launches += add(bench_phase(card, device))
    log(f"    phase 10: {time.perf_counter() - t10:.1f} s")

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
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "stif_tpu_torch/csrc/deform_conv.cu",
        "replaces": replaces,  # XLA gathers and an einsum: the JAX package
        "launches": n,         # has no Pallas kernel for the DCN
        "max_abs_err": dcn[name][0],
        "ms": dcn[name][1],
        "plain_ms": dcn[name][2],
        "bound_ms": dcn[name][3],
        "bound_by": dcn[name][4],
        "library_ms": None,  # no PyTorch call computes a deformable conv
    } for name, replaces, n in (
        ("dcn_forward", "stif_tpu/ops/deform_conv.py:236-273",
         dcn_launches[0]),
        ("dcn_backward", "stif_tpu/ops/deform_conv.py:161",
         dcn_launches[1]))]}
    log(f"[6] done in {time.perf_counter() - t_start:.1f} s; SIREN kernel "
        "times are the sum of the deployed model's three nets of one window, "
        "DCN kernel times those of one L1 call (96x160, B 1); launches the "
        "sum over every path driven")
    log(card)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
