"""The fused DCN kernels' CPU side: their plain versions against the JAX
package, their launch plans, the 3xTF32 product they use, and the build
cache's hash over the sources they share.

- ``dcn_forward_plain`` against ``stif_tpu.ops.deform_conv.deform_conv2d``
  and ``dcn_backward_plain`` against ``jax.vjp`` of it, on the same
  numpy-seeded inputs: stride 2, dilation 2, ``impl="dense"`` at
  ``shift_bound`` 2, integer positions (zero offsets) and Cin 24 in 4
  groups (6 channels a group). Bars: forward atol 2e-5 (fp32 sums over
  K*Cin terms in another order), gradients 2e-5 x max|g|.
- ``launch_plan`` on the main path's shapes and on ragged and padded ones.
- A numpy emulation of the kernels' 3xTF32 product (operands split into
  round-to-nearest 10-bit-mantissa halves) at the magnitudes of the
  encoder's largest call: within 1e-5 of max|out| of the float64 product,
  where one TF32 pass is not.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stif_tpu.ops import deform_conv as jdc

from stif_tpu_torch.ops import cuda_build
from stif_tpu_torch.ops import deform_conv as dc
from torch_parity import t

ATOL = 2e-5
GRAD_RTOL = 2e-5  # of the gradient's largest magnitude

# (B, H, W, G, Cin, Cout, stride, dilation, offsets, shift bound)
CASES = {
    "stride2": (2, 9, 11, 4, 16, 12, 2, 1, 6.0, None),
    "dilation2": (2, 8, 9, 4, 16, 12, 1, 2, 3.0, None),
    "dense_bound2": (2, 8, 10, 4, 16, 12, 1, 1, 4.0, 2),
    "integer": (2, 7, 9, 4, 16, 12, 1, 1, 0.0, None),
    "cin24_g4": (2, 7, 9, 4, 24, 24, 1, 1, 2.5, None),
}


def _inputs(case, seed=0):
    B, H, W, G, cin, cout, stride, dil, scale, _ = CASES[case]
    rng = np.random.default_rng(seed)
    Ho = (H + 2 - 2 * dil - 1) // stride + 1
    Wo = (W + 2 - 2 * dil - 1) // stride + 1
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    off = rng.uniform(-scale, scale, (B, Ho, Wo, G, 9, 2)).astype(np.float32)
    mask = rng.random((B, Ho, Wo, G, 9)).astype(np.float32)
    w_hwio = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    cot = rng.standard_normal((B, Ho, Wo, cout)).astype(np.float32)
    return x, off, mask, w_hwio, b, cot


def _jax_kw(case):
    stride, dil, S = CASES[case][6], CASES[case][7], CASES[case][9]
    kw = dict(stride=stride, padding=1, dilation=dil)
    return kw, (dict(impl="patch") if S is None
                else dict(impl="dense", shift_bound=S))


def _torch_geom(case):
    stride, dil, S = CASES[case][6], CASES[case][7], CASES[case][9]
    return stride, 1, dil, S


@pytest.mark.parametrize("case", list(CASES))
def test_forward_plain_against_jax(case):
    x, off, mask, w_hwio, b, _ = _inputs(case)
    kw, impl = _jax_kw(case)
    want = np.asarray(jdc.deform_conv2d(*map(jnp.asarray, (x, off, mask,
                                                           w_hwio, b)),
                                        **kw, **impl))
    got = dc.dcn_forward_plain(t(x), t(off), t(mask),
                               t(w_hwio.transpose(3, 2, 0, 1)), t(b),
                               *_torch_geom(case))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_backward_plain_against_jax_vjp(case):
    """Grad x, offset, mask and weight (OIHW) of ``dcn_backward_plain``
    against ``jax.vjp`` of the JAX op at the same cotangent; the bias's
    gradient is the cotangent's sum in both."""
    x, off, mask, w_hwio, b, cot = _inputs(case)
    kw, impl = _jax_kw(case)
    _, vjp = jax.vjp(lambda *a: jdc.deform_conv2d(*a, b, **kw, **impl),
                     *map(jnp.asarray, (x, off, mask, w_hwio)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    want[3] = want[3].transpose(3, 2, 0, 1)
    got = dc.dcn_backward_plain(t(cot), t(x), t(off), t(mask),
                                t(w_hwio.transpose(3, 2, 0, 1)),
                                *_torch_geom(case))
    for name, g, w in zip(("x", "offset", "mask", "weight"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name,
                                   atol=GRAD_RTOL * np.abs(w).max())


def test_function_backward_is_dcn_backward():
    """On the CPU the Function's gradients are ``dcn_backward_plain``'s,
    and the bias's is the cotangent's sum."""
    x, off, mask, w_hwio, b, cot = _inputs("cin24_g4")
    ins = [t(v).requires_grad_(True) for v in
           (x, off, mask, w_hwio.transpose(3, 2, 0, 1), b)]
    y = dc.DeformConv2dFunction.apply(*ins, (1, 1, 1, None))
    y.backward(t(cot))
    want = dc.dcn_backward_plain(t(cot), *[v.detach() for v in ins[:4]])
    for v, w in zip(ins, list(want) + [t(cot).reshape(-1, 24).sum(0)]):
        torch.testing.assert_close(v.grad, w, rtol=0, atol=0)


# ------------------------------------------------------------ launch plans

def _check_plan(plan, pixels, cin, groups, cout, taps):
    """What every plan must hold, whatever the shape."""
    n_tiles = -(-pixels // plan.tile_rows)
    assert plan.chunk <= min(cin, dc.MAX_CHUNK)
    assert plan.chunk * taps <= dc.MAX_RUN or plan.chunk < 8
    assert plan.chunk_pad % 8 == 0 and plan.chunk <= plan.chunk_pad
    assert plan.chunk_pad < plan.chunk + 8
    assert plan.n_chunks * plan.chunk >= cin > (plan.n_chunks - 1) * plan.chunk
    assert plan.n_col_tiles * dc.TILE_N >= cout > (plan.n_col_tiles - 1) * 64
    assert plan.smem_bytes <= 232448
    flat = plan.flat()
    if plan.kind == "forward":
        assert plan.tile_rows in (64, 128) and plan.threads == 512
        assert plan.grid == (n_tiles, plan.n_col_tiles)
        # 64-pixel tiles only where they all fit in one wave of the SMs
        assert (plan.tile_rows == 64) == (
            -(-pixels // 64) * plan.n_col_tiles <= dc.SMS)
        assert plan.weight_pitch >= plan.chunk_pad * taps
        assert plan.weight_pitch % 32 == 4  # no bank conflicts
        rows = plan.tile_rows
        assert plan.smem_bytes == (16 + 4 * (64 * plan.weight_pitch
                                             + 2 * rows * 68) + 32 * rows)
        assert len(flat) == 10 and flat[-1] == plan.weight_pitch
    else:
        assert (plan.tile_rows, plan.threads) == (64, 256)
        parts, per_tile = plan.grid
        assert per_tile == taps * plan.n_chunks * plan.n_col_tiles
        assert parts * plan.tiles_per_block >= n_tiles
        assert (parts - 1) * plan.tiles_per_block < max(n_tiles, 1)
        assert len(flat) == 11
        assert flat[-1] == int(plan.accumulate)
    assert flat[:9] == [plan.tile_rows, plan.threads, plan.chunk,
                        plan.chunk_pad, plan.n_chunks, plan.n_col_tiles,
                        plan.smem_bytes, *plan.grid]


# the main path's DCN calls: L1 96x160, L2 48x80, L3 24x40 at B 1 (gen_feat)
# and B 2 (both ConvLSTM directions), nf 64 in 8 groups
MAIN = [(b * h * w, lvl) for lvl, (h, w) in
        {"L1": (96, 160), "L2": (48, 80), "L3": (24, 40)}.items()
        for b in (1, 2)]


@pytest.mark.parametrize("pixels,level", MAIN)
def test_launch_plan_main_path(pixels, level):
    fwd = dc.launch_plan("forward", pixels, 64, 8, 64)
    bwd = dc.launch_plan("backward", pixels, 64, 8, 64)
    for plan in (fwd, bwd):
        _check_plan(plan, pixels, 64, 8, 64, 9)
        assert (plan.chunk, plan.chunk_pad, plan.n_chunks,
                plan.n_col_tiles) == (64, 64, 1, 1)
    rows = 128 if level == "L1" else 64  # L2 and L3 fit in one wave
    assert fwd.weight_pitch == 580 and fwd.tile_rows == rows
    assert fwd.smem_bytes == {128: 222224, 64: 185360}[rows]
    assert fwd.grid == (-(-pixels // rows), 1)
    assert bwd.smem_bytes == 71696 and not bwd.accumulate
    # about three backward blocks per SM, never fewer tiles than pixels
    blocks = bwd.grid[0] * bwd.grid[1]
    assert blocks <= dc.TARGET_BLOCKS + bwd.grid[1]
    if level == "L1":  # 240 or 480 tiles of 64 pixels, 9 taps
        assert (bwd.tiles_per_block, bwd.grid) == {
            15360: (6, (40, 9)), 30720: (11, (44, 9))}[pixels]


@pytest.mark.parametrize("pixels,cin,groups,cout,taps,want", [
    # (chunk, padded, chunks, column tiles, accumulate)
    (126, 24, 4, 24, 9, (24, 24, 1, 1, False)),     # CpG 6
    (126, 12, 4, 3, 9, (12, 16, 1, 1, False)),      # CpG 3, Cout 3: padded
    (30, 96, 1, 8, 9, (64, 64, 2, 1, True)),        # a group split in two
    (42, 16, 4, 80, 9, (16, 16, 1, 2, True)),       # two column tiles
    (30, 16, 2, 12, 25, (16, 16, 1, 1, False)),     # 5x5
    (30, 64, 8, 64, 25, (16, 16, 4, 1, False)),     # 5x5: 400 weights a run
    (1, 8, 2, 8, 9, (8, 8, 1, 1, False)),           # one pixel
    (0, 64, 8, 64, 9, (64, 64, 1, 1, False)),       # no pixels
    (4097, 40, 5, 7, 1, (40, 40, 1, 1, False)),     # 1x1, ragged tiles
    (77, 8, 2, 8, 72, (8, 8, 1, 1, False)),         # 9x8: 576 weights a run
    (77, 16, 2, 8, 72, (8, 8, 2, 1, False)),        # 9x8: two chunks
])
def test_launch_plan_ragged_and_padded(pixels, cin, groups, cout, taps,
                                       want):
    for kind in ("forward", "backward"):
        plan = dc.launch_plan(kind, pixels, cin, groups, cout, taps)
        _check_plan(plan, pixels, cin, groups, cout, taps)
        assert (plan.chunk, plan.chunk_pad, plan.n_chunks,
                plan.n_col_tiles) == want[:4]
        if kind == "backward":
            assert plan.accumulate == want[4]


@pytest.mark.parametrize("args", [
    (100, 64, 8, 64, 81),    # 9x9: more taps than a weight tile holds
    (100, 30, 4, 64, 9),     # Cin not a multiple of the groups
    (100, 64, 8, 0, 9),      # no output channel
    (-1, 64, 8, 64, 9),
])
def test_launch_plan_refuses(args):
    for kind in ("forward", "backward"):
        with pytest.raises(ValueError):
            dc.launch_plan(kind, *args)


# ------------------------------------------------------------ 3xTF32

def _tf32(a: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round to nearest (ties away from zero) to 10
    mantissa bits; the result is a float32 with its low 13 bits zero."""
    u = a.astype(np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_tf32_rounding():
    a = np.array([1.0, 1 + 2**-11, 1 + 2**-10 + 2**-11, -(1 + 2**-11),
                  1 + 2**-12, 3.0e-38], np.float32)
    want = np.array([1.0, 1 + 2**-10, 1 + 2**-9, -(1 + 2**-10), 1.0,
                     3.0e-38], np.float32)
    got = _tf32(a)
    np.testing.assert_allclose(got, want, rtol=2**-11)
    assert (got.view(np.uint32) & 0x1FFF == 0).all()


def test_3xtf32_product_holds_fp32_accuracy(record_property):
    """The forward's contraction at the encoder's largest call (K*Cin 576,
    Cout 64; 4,096 of its 15,360 rows): columns of bilinear samples of
    features with a heavy tail (|x| up to ~20) times a mask, weights of
    scale 1/sqrt(576) with outliers. 3xTF32 (a_lo*b_hi + a_hi*b_lo +
    a_hi*b_hi, fp32 sums) stays within 1e-5 of max|out| of the float64
    product; one TF32 pass does not."""
    rng = np.random.default_rng(8)
    cols = (rng.standard_t(3, (4096, 576)) * rng.random((4096, 576))
            ).astype(np.float32)
    w = (rng.standard_normal((576, 64)) / 24.0).astype(np.float32)
    w[rng.random(w.shape) < 0.01] *= 8.0
    exact = cols.astype(np.float64) @ w.astype(np.float64)
    a_hi, b_hi = _tf32(cols), _tf32(w)
    a_lo, b_lo = _tf32(cols - a_hi), _tf32(w - b_hi)
    three = (a_lo @ b_hi) + (a_hi @ b_lo) + (a_hi @ b_hi)  # float32 sums
    one = a_hi @ b_hi
    scale = np.abs(exact).max()
    err3 = np.abs(three - exact).max() / scale
    err1 = np.abs(one - exact).max() / scale
    err_fp32 = np.abs(cols @ w - exact).max() / scale
    record_property("3xtf32_rel_err", float(err3))
    record_property("1xtf32_rel_err", float(err1))
    record_property("fp32_rel_err", float(err_fp32))
    assert err3 <= 1e-5
    assert err1 > 1e-4 > 10 * err3  # one pass misses the kernels' 1e-4 bar


# ------------------------------------------------------------ the build

def test_library_path_hashes_the_shared_headers(tmp_path, monkeypatch):
    """A kernel's library is named by its source, the headers of ``csrc``
    (``*.cuh``, which sources include) and the flags: an edited header
    names a new library, so a stale one is never loaded."""
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    first = cuda_build.library_path("k")
    assert first == cuda_build.library_path("k")
    (tmp_path / "notes.txt").write_text("not a header")
    assert cuda_build.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = cuda_build.library_path("k")
    assert second != first
    (tmp_path / "g.cuh").write_text("// another header\n")
    assert cuda_build.library_path("k") not in (first, second)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert cuda_build.library_path("k").parent == tmp_path / "_build"
    assert cuda_build.library_path("k").name.startswith("libk_")


def test_port_kernels_share_the_async_copy_header():
    """Both kernels include ``async_copy.cuh`` and define none of its
    helpers themselves."""
    for name in ("siren_fused", "deform_conv"):
        src = (cuda_build.CSRC / f"{name}.cu").read_text()
        assert '#include "async_copy.cuh"' in src
        assert "void mbar_wait(" not in src and "void bulk_copy(" not in src
