"""The port's CUDA kernel on the card: builds, agrees with its plain
version, and raises rather than falling back. Marked ``cuda``; skipped
where there is no GPU. Needs no JAX: on a GPU host without it, run
``python -m pytest tests/test_torch_cuda.py -q --noconftest``."""

import contextlib

import numpy as np
import pytest
import torch

from stif_tpu_torch.ops import siren_apply_fused, siren_apply_fused_plain

pytestmark = pytest.mark.cuda

NETS = {
    "feat_imnet": ([200, 1], [64, 64, 256, 64]),
    "flow_imnet": ([64, 192, 6, 1], [64, 64, 256, 4]),
    "encode_imnet": ([64, 64, 192, 192, 6, 6, 1], [64, 64, 256, 256, 3]),
}


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _net(rng, splits, widths, device):
    dims = [sum(splits)] + widths
    ws, bs = [], []
    for i in range(len(widths)):
        n = dims[i]
        bound = 1.0 / n if i == 0 else np.sqrt(6.0 / n) / 30.0
        ws.append(torch.tensor(rng.uniform(-bound, bound, (n, dims[i + 1])),
                               dtype=torch.float32, device=device))
        bs.append(torch.tensor(rng.uniform(-1, 1, dims[i + 1]) / np.sqrt(n),
                               dtype=torch.float32, device=device))
    return ws, bs


@pytest.mark.parametrize("name", list(NETS))
@pytest.mark.parametrize("q", [4097, 65536])
def test_kernel_matches_plain(cuda, rng, name, q):
    splits, widths = NETS[name]
    ws, bs = _net(rng, splits, widths, cuda)
    xs = [torch.tensor(rng.uniform(-1, 1, (q, c)), dtype=torch.float32,
                       device=cuda) for c in splits]
    before = siren_apply_fused.launches
    got = siren_apply_fused(xs, ws, bs)
    torch.cuda.synchronize()
    assert siren_apply_fused.launches == before + 1
    want = siren_apply_fused_plain(xs, ws, bs)
    assert (got - want).abs().max().item() <= 1e-4


def _decoder_fields(name, nt, Q, device):
    """One net's fields laid out as the decoder hands them over: ``expand``
    views over the time axis (row period Q), column slices of 198-wide
    tensors (row stride 198 floats: 8-byte-aligned rows), contiguous ones."""
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


@pytest.mark.parametrize("name", list(NETS))
@pytest.mark.parametrize("nt", [1, 3])
@pytest.mark.parametrize("Q", [1, 63, 64, 65, 65537])
def test_kernel_matches_plain_decoder_layouts(cuda, rng, name, nt, Q):
    """Strided column slices, fields broadcast over time (nt = 3: row period
    < rows) and ragged row counts around the 64-row tile."""
    splits, widths = NETS[name]
    ws, bs = _net(rng, splits, widths, cuda)
    torch.manual_seed(0)
    xs = _decoder_fields(name, nt, Q, cuda)
    assert [x.shape[-1] for x in xs] == splits
    got = siren_apply_fused(xs, ws, bs)
    torch.cuda.synchronize()
    want = siren_apply_fused_plain(xs, ws, bs)
    assert got.shape == want.shape == (nt, Q, widths[-1])
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("case", ["hidden_16", "out_5", "first_layer_wide",
                                  "single_layer", "k_exact_chunks"])
def test_kernel_matches_plain_odd_widths(cuda, rng, case):
    """Widths off the 64 / 256 tiles run padded; a lone layer is tiled."""
    splits, widths = {
        "hidden_16": ([8], [16, 4]),
        "out_5": ([200, 1], [64, 5]),
        "first_layer_wide": ([20, 20], [256, 256, 64]),
        "single_layer": ([9], [3]),
        "k_exact_chunks": ([100, 28], [64, 256, 3]),
    }[case]
    ws, bs = _net(rng, splits, widths, cuda)
    xs = [torch.tensor(rng.uniform(-1, 1, (1000, c)), dtype=torch.float32,
                       device=cuda) for c in splits]
    got = siren_apply_fused(xs, ws, bs)
    torch.cuda.synchronize()
    want = siren_apply_fused_plain(xs, ws, bs)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("scale", [1e2, 1e5, 1e8])
def test_kernel_sine(cuda, scale):
    """The kernel's sine against a float64 sine of the same fp32 argument
    (bar 5e-7; ``sinf`` itself is good to 2 ulp): inside its fast range
    (|x| <= 105615) and beyond, where it hands over to ``sinf``."""
    w0 = torch.full((1, 4), 1.0 / 30.0, device=cuda)
    ws = [w0, torch.eye(4, device=cuda)]
    bs = [torch.zeros(4, device=cuda)] * 2
    torch.manual_seed(0)
    x = (torch.rand(1 << 18, 1, device=cuda) * 2 - 1) * scale
    got = siren_apply_fused([x], ws, bs)
    torch.cuda.synchronize()
    arg = 30.0 * (x * w0)
    err = (got.double() - torch.sin(arg.double())).abs().max().item()
    assert err <= 5e-7


def test_kernel_rejects_bad_inputs(cuda, rng):
    ws, bs = _net(rng, [8], [16, 4], cuda)
    x = torch.zeros(10, 8, device=cuda)
    with pytest.raises(ValueError):  # float64 field
        siren_apply_fused([x.double()], ws, bs)
    with pytest.raises(ValueError):  # non-contiguous weight
        siren_apply_fused([x], [ws[0].t().contiguous().t(), ws[1]], bs)
    with pytest.raises(ValueError):  # column-strided field
        siren_apply_fused([torch.zeros(8, 10, device=cuda).t()], ws, bs)


def _chunk_fields(name, nt, B, Cq, device):
    """One net's fields as the chunked decode stages hand them over:
    separate contiguous gathers, the time-independent ones broadcast over
    the time axis (row period B * Cq)."""
    def r(*shape):
        return torch.rand(*shape, device=device) * 2 - 1

    def tile_t(v):
        return v.expand(nt, *v.shape)

    if name == "feat_imnet":
        return [tile_t(r(B, Cq, 200)), r(nt, B, Cq, 1)]
    if name == "flow_imnet":
        return [r(nt, B, Cq, 64), tile_t(r(B, Cq, 192)), tile_t(r(B, Cq, 6)),
                r(nt, B, Cq, 1)]
    return [r(nt * B, Cq, c) for c in NETS[name][0]]


@pytest.mark.parametrize("name", list(NETS))
@pytest.mark.parametrize("B,Cq", [(1, 65536), (2, 30001), (2, 63)])
def test_kernel_matches_plain_chunk_layouts(cuda, rng, name, B, Cq):
    """The chunked stages' shapes: 8 times x one chunk of queries, and a
    batch of two, where the broadcast fields' row period is B * Cq."""
    splits, widths = NETS[name]
    ws, bs = _net(rng, splits, widths, cuda)
    torch.manual_seed(0)
    xs = _chunk_fields(name, 8, B, Cq, cuda)
    got = siren_apply_fused(xs, ws, bs)
    torch.cuda.synchronize()
    want = siren_apply_fused_plain(xs, ws, bs)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-4


# the model zoo's six nets: field splits, widths after the input
ZOO_NETS = {
    "train_feat": ([200], [64, 64, 64, 256, 128]),
    "train_flow": ([128, 200, 1], [64, 64, 64, 256, 4]),
    "train_encode": ([128, 198, 128, 198], [64, 64, 64, 256, 256, 27]),
    "s_flow": ([200, 1], [64, 64, 256, 4]),
    "s_encode": ([192, 192, 6, 6], [64, 64, 256, 256, 3]),
    "noflow_feat": ([200, 1], [64, 64, 256, 256, 256, 3]),
}


def _zoo_fields(name, nt, Q, device):
    """One zoo net's fields as its model hands them over: the base field
    broadcast over the times (row period Q), contiguous gathers, the time
    column."""
    def r(*shape):
        return torch.rand(*shape, device=device) * 2 - 1

    if name == "train_feat":
        return [r(Q, 200).expand(nt, Q, 200)]
    if name == "train_flow":
        return [r(nt, Q, 128), r(Q, 200).expand(nt, Q, 200), r(nt, Q, 1)]
    if name in ("s_flow", "noflow_feat"):
        return [r(Q, 200).expand(nt, Q, 200), r(nt, Q, 1)]
    return [r(nt, Q, c) for c in ZOO_NETS[name][0]]


@pytest.mark.parametrize("name", list(ZOO_NETS))
@pytest.mark.parametrize("nt,Q", [(1, 1), (3, 63), (3, 65), (2, 4097),
                                  (8, 65536)])
def test_kernel_matches_plain_zoo_nets(cuda, rng, name, nt, Q):
    """A 128-wide last layer on the 256 tile, a 27-wide one on the 64 tile,
    652 input columns from four fields, six layers, 256 -> 256 twice."""
    splits, widths = ZOO_NETS[name]
    ws, bs = _net(rng, splits, widths, cuda)
    torch.manual_seed(0)
    xs = _zoo_fields(name, nt, Q, cuda)
    assert [x.shape[-1] for x in xs] == splits
    before = siren_apply_fused.launches
    got = siren_apply_fused(xs, ws, bs)
    torch.cuda.synchronize()
    assert siren_apply_fused.launches == before + 1
    want = siren_apply_fused_plain(xs, ws, bs)
    assert got.shape == want.shape == (nt, Q, widths[-1])
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("name,launches", [
    ("LunaTokisTrain", 3), ("LunaTokisS", 2), ("LunaTokisNoFlow", 1),
    ("LunaTokisZSM", 0), ("LIIF_test3", 0), ("LIIF_continuous", 0)])
def test_zoo_models_launch_the_kernel(cuda, name, launches):
    """Each model of the zoo on the card against itself with the plain
    SIREN (1e-4), a batch of two, with the launches it must make; the
    ablations and the fixed-x4 model make none."""
    from stif_tpu_torch.models import make_model
    from stif_tpu_torch.nn import Siren

    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    model = make_model(name, nf=16, groups=4, front_RBs=1,
                       back_RBs=1).to(cuda).eval()
    x = torch.rand(2, 2, 8, 12, 3, device=cuda)
    args = () if name == "LunaTokisZSM" else (
        torch.tensor([0.0, 0.4, 1.0], device=cuda),)
    with torch.inference_mode():
        before = siren_apply_fused.launches
        got = model(x, *args)
        assert siren_apply_fused.launches == before + launches
        for m in model.modules():
            if isinstance(m, Siren):
                m.fused = False
        want = model(x, *args)
        assert siren_apply_fused.launches == before + launches
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4


def test_tmnet_on_the_card_matches_cpu(cuda):
    from stif_tpu_torch.models import TMNet
    from stif_tpu_torch.runtime import InferencePipeline

    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    model = TMNet(nf=16, groups=4, front_RBs=1, back_RBs=1)
    for p in model.parameters():  # the offset convs start at zero
        if p.abs().max() == 0:
            torch.nn.init.uniform_(p, -0.05, 0.05)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    frames = np.random.default_rng(0).random((3, 8, 12, 3)).astype(np.float32)
    got = InferencePipeline(model, bucket=4).render_window_tmnet(
        frames, [0.25, 0.75])
    ref = TMNet(nf=16, groups=4, front_RBs=1, back_RBs=1)
    ref.load_state_dict(state)
    want = InferencePipeline(ref, bucket=4, device="cpu").render_window_tmnet(
        frames, [0.25, 0.75])
    assert got.shape == want.shape == (7, 32, 48, 3)
    assert np.abs(got - want).max() <= 1e-4


@pytest.fixture
def small_model(cuda):
    from stif_tpu_torch.models import LunaTokis

    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    state = LunaTokis(nf=16, groups=4, front_RBs=1, back_RBs=1).state_dict()

    def build(**kw):
        model = LunaTokis(nf=16, groups=4, front_RBs=1, back_RBs=1,
                          rgb_skip=True, rgb_skip_bicubic=True, **kw)
        model.load_state_dict(state)
        return model.to(cuda).eval()

    x = torch.rand(2, 2, 8, 12, 3, device=cuda)
    return build, x, torch.tensor([0.0, 0.4, 1.0], device=cuda)


@pytest.mark.parametrize("case,launches", [
    ("full", 3), ("local_ensemble", 12), ("test_mode", 3), ("zoom", 3),
    ("mlp_dtype", 0)])
def test_decode_paths_launch_the_kernel(small_model, case, launches):
    """Each decode path on the card against the same path with the plain
    SIREN (1e-4), with the launches it must make; ``mlp_dtype`` makes none."""
    build, x, times = small_model
    kw = dict(mlp_dtype=torch.bfloat16) if case == "mlp_dtype" else {}
    model, plain = build(**kw), build(fused=False, **kw)

    def run(m):
        feat = m.gen_feat(x)
        if case == "zoom":
            return m.decode_zoom(feat, x, times, (64, 96), (9, 14),
                                 (0.2, -0.1))
        return m.decode(feat, x, times,
                        local_ensemble=case == "local_ensemble",
                        hr_inp_upsample=case == "test_mode")

    with torch.inference_mode():
        before = siren_apply_fused.launches
        got = run(model)
        assert siren_apply_fused.launches == before + launches
        want = run(plain)
        assert siren_apply_fused.launches == before + launches
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("chunk", [512, 500, 4096])
def test_chunked_decoder_on_the_card(small_model, chunk):
    """Chunked against the full decode of the same features (1e-4), a batch
    of two, 3 launches per chunk step; the decoder's passes are CUDA graphs
    by default, so the first decode adds the eager warm-ups of the two chunk
    passes (2 launches in A+B, 1 in C+D)."""
    from stif_tpu_torch.runtime import ChunkedDecoder

    build, x, times = small_model
    model = build()
    with torch.inference_mode():
        feat = model.gen_feat(x)
        want = model.decode(feat, x, times).cpu().numpy()
    before = siren_apply_fused.launches
    got = ChunkedDecoder(model, chunk).decode(feat, x, times, (32, 48))
    steps = -(-32 * 48 // min(chunk, 32 * 48))
    assert siren_apply_fused.launches == before + 3 * steps + 3
    assert np.abs(got - want).max() <= 1e-4


def test_round_to_fp8_saturates_on_the_card(cuda):
    from stif_tpu_torch.ops.precision import round_to

    x = torch.tensor([1000.0, -500.0, 448.0, 465.0, 0.3], device=cuda)
    got = round_to(x, torch.float8_e4m3fn).cpu()
    assert got.tolist() == [448.0, -448.0, 448.0, 448.0, 0.3125]
    assert torch.equal(got, round_to(x.cpu(), torch.float8_e4m3fn))


# ---------------------------------------------------------------- training

def test_kernel_refuses_grad_mode(cuda, rng):
    """The kernel has no backward: with grad mode on and an operand that
    requires grad it raises instead of returning an output with no history;
    under ``no_grad`` / ``inference_mode``, or with no operand requiring
    grad, it launches."""
    splits, widths = NETS["flow_imnet"]
    ws, bs = _net(rng, splits, widths, cuda)
    xs = [torch.rand(256, c, device=cuda) for c in splits]
    ws[1].requires_grad_(True)
    before = siren_apply_fused.launches
    with pytest.raises(RuntimeError, match="no backward"):
        siren_apply_fused(xs, ws, bs)
    assert siren_apply_fused.launches == before
    with torch.no_grad():
        siren_apply_fused(xs, ws, bs)
    with torch.inference_mode():
        siren_apply_fused(xs, ws, bs)
    ws[1].requires_grad_(False)
    xs[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="fused=False"):
        siren_apply_fused(xs, ws, bs)
    xs[0].requires_grad_(False)
    siren_apply_fused(xs, ws, bs)
    assert siren_apply_fused.launches == before + 3


def test_train_step_on_the_card_matches_cpu(cuda, tmp_path):
    """One ``VideoSRModel`` step from the same init at nf 8 (B 2, LR 8x8,
    GT 32x32, nt 2) on the card and on the CPU: loss rtol 1e-4, grad norm
    rtol 1e-3; the training step launches no kernel, ``test`` does."""
    from stif_tpu_torch.train.video_sr_model import VideoSRModel

    torch.backends.cudnn.allow_tf32 = False
    opt = {"network_G": dict(which_model_G="LIIF", nf=8, nframes=6,
                             groups=2, front_RBs=1, back_RBs=1,
                             rgb_skip="bicubic"),
           "train": dict(lr_G=1e-4, warmup_iter=-1, T_period=[100],
                         restarts=[], restart_weights=[], grad_clip=1e6,
                         ema_decay=0.999)}
    rng = np.random.default_rng(0)
    batch = {"LQs": rng.random((2, 2, 8, 8, 3)).astype(np.float32),
             "GT": rng.random((2, 2, 32, 32, 3)).astype(np.float32),
             "times": np.asarray([[0.0, 0.5], [1.0, 0.25]], np.float32)}
    logs = []
    for device in (cuda, "cpu"):
        m = VideoSRModel(opt, device=device)
        m.init_params(batch["LQs"], batch["times"], seed=3)
        m.feed_data(batch)
        before = siren_apply_fused.launches
        logs.append(m.optimize_parameters())
        if device == cuda:
            assert siren_apply_fused.launches == before
            m.test()
            assert siren_apply_fused.launches == before + 3
    gpu, cpu = logs
    np.testing.assert_allclose(gpu["loss"], cpu["loss"], rtol=1e-4)
    np.testing.assert_allclose(gpu["grad_norm"], cpu["grad_norm"], rtol=1e-3)


# --------------------------------------------------- parallel and streaming

def test_data_parallel_step_at_world_size_one(cuda):
    """Three DDP steps over NCCL at world size 1 (B 2, nf 8) against three
    single-process steps from the same init: loss rtol 1e-5, grad norm rtol
    1e-4."""
    import torch.distributed as dist

    from stif_tpu_torch.parallel.distributed import free_port
    from stif_tpu_torch.train.video_sr_model import VideoSRModel

    torch.backends.cudnn.allow_tf32 = False
    opt = {"network_G": dict(which_model_G="LIIF", nf=8, nframes=6,
                             groups=2, front_RBs=1, back_RBs=1,
                             rgb_skip="bicubic"),
           "train": dict(lr_G=1e-4, warmup_iter=-1, T_period=[100],
                         restarts=[], restart_weights=[], grad_clip=1e6)}
    rng = np.random.default_rng(0)
    batch = {"LQs": rng.random((2, 2, 8, 8, 3)).astype(np.float32),
             "GT": rng.random((2, 2, 32, 32, 3)).astype(np.float32),
             "times": np.asarray([[0.0, 0.5], [1.0, 0.25]], np.float32)}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        logs = []
        for parallel in (True, False):
            m = VideoSRModel(opt, device=cuda, parallel=parallel)
            m.init_params(batch["LQs"], batch["times"], seed=3)
            m.feed_data(batch)
            logs.append([m.optimize_parameters() for _ in range(3)])
    finally:
        dist.destroy_process_group()
    for got, want in zip(*logs):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-4)


def test_mesh_chunked_decoder_on_the_card(small_model):
    """Two handles of one card drive the n_par 2 dispatch: within 1e-5 of
    the single-device chunked decode, 3 launches per chunk; a mesh of size
    1 gives the single-device output bitwise."""
    from stif_tpu_torch.parallel import default_mesh, make_mesh
    from stif_tpu_torch.runtime import ChunkedDecoder

    build, x, times = small_model
    model = build()
    with torch.inference_mode():
        feat = model.gen_feat(x)
    one = ChunkedDecoder(model, 500).decode(feat, x, times, (32, 48))
    before = siren_apply_fused.launches
    mesh = make_mesh({"model": 2}, [torch.device("cuda", 0)] * 2)
    got = ChunkedDecoder(model, 500, mesh=mesh).decode(feat, x, times,
                                                       (32, 48))
    assert siren_apply_fused.launches == before + 3 * 4  # 2 steps x 2
    assert np.abs(got - one).max() <= 1e-5
    same = ChunkedDecoder(model, 500, mesh=default_mesh(1)).decode(
        feat, x, times, (32, 48))
    np.testing.assert_array_equal(same, one)


def test_render_sequence_on_the_card(small_model):
    """The double-buffered sequence (copies on a side stream into pinned
    memory) equals the back-to-back windows bitwise, 3 launches per pair,
    and 3 in the eager warm-up of the bucket's capture."""
    from stif_tpu_torch.runtime import InferencePipeline

    build, _, _ = small_model
    pipe = InferencePipeline(build(), bucket=4)
    frames = np.random.default_rng(1).random((5, 8, 12, 3)).astype(
        np.float32)
    before = siren_apply_fused.launches
    got = pipe.render_sequence(frames, n_times=3)
    assert pipe.programs.captures == 1
    assert siren_apply_fused.launches == before + 12 + 3
    for i, out in enumerate(got):
        want = pipe.render_window(frames[i:i + 2], [0.0, 1 / 3, 2 / 3])
        np.testing.assert_array_equal(out, want)


def _cards(n):
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA GPUs")
    return [torch.device("cuda", i) for i in range(n)]


def test_pipeline_on_a_card_that_is_not_current(small_model):
    """A pipeline on ``cuda:1`` while ``cuda:0`` is current: its events,
    copy stream, captures and replays follow its own card, so the
    double-buffered frames equal the back-to-back ones and an eager
    pipeline's on that card bitwise, and those of a pipeline on
    ``cuda:0``."""
    from stif_tpu_torch.runtime import InferencePipeline

    cards = _cards(2)
    build, _, _ = small_model
    torch.cuda.set_device(0)
    frames = np.random.default_rng(2).random((5, 48, 64, 3)).astype(
        np.float32)
    times = [0.0, 1 / 3, 2 / 3]
    ref = InferencePipeline(build(), bucket=4, device=cards[0])
    pipe = InferencePipeline(build(), bucket=4, device=cards[1])
    eager = InferencePipeline(pipe.model, bucket=4, device=cards[1],
                              compiled=False)
    got = pipe.render_sequence(frames, n_times=3)
    assert torch.cuda.current_device() == 0
    assert pipe.programs.captures == 1
    for i, out in enumerate(got):
        np.testing.assert_array_equal(
            out, pipe.render_window(frames[i:i + 2], times))
        np.testing.assert_array_equal(
            out, eager.render_window(frames[i:i + 2], times))
        want = ref.render_window(frames[i:i + 2], times)
        assert np.abs(out - want).max() <= 1e-5


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_chunked_decoder_over_cards(small_model, n):
    """The mesh ``ChunkedDecoder`` over ``n`` distinct cards (a replica of
    the model on each, the HR field gathered to the first card and
    replicated back) against the single-card decode: within 1e-5, 3
    launches per chunk."""
    from stif_tpu_torch.parallel import make_mesh
    from stif_tpu_torch.runtime import ChunkedDecoder

    cards = _cards(n)
    build, x, times = small_model
    model = build()
    with torch.inference_mode():
        feat = model.gen_feat(x)
    one = ChunkedDecoder(model, 300).decode(feat, x, times, (32, 48))
    dec = ChunkedDecoder(build(), 300, mesh=make_mesh({"model": n}, cards))
    assert len(dec._replicas) == n
    before = siren_apply_fused.launches
    got = dec.decode(feat, x, times, (32, 48))
    steps = -(-32 * 48 // (300 * n))
    assert siren_apply_fused.launches == before + 3 * n * steps
    assert np.abs(got - one).max() <= 1e-5


# ------------------------------------------------------------ DCN kernels

def _dcn_inputs(device, B, H, W, Cin, G, stride=1, dilation=1, scale=6.0,
                strided=False, seed=0):
    """x, offset and mask of a 3x3 DCN; with ``strided`` the offset is the
    view ``split_offset_mask`` makes of a raw conv output."""
    from stif_tpu_torch.ops import split_offset_mask

    g = torch.Generator().manual_seed(seed)
    Ho = (H + 2 - 2 * dilation - 1) // stride + 1
    Wo = (W + 2 - 2 * dilation - 1) // stride + 1
    x = torch.randn(B, H, W, Cin, generator=g).to(device)
    if strided:  # split on the card: a copy to it would be contiguous
        raw = (torch.rand(B, Ho, Wo, 27 * G, generator=g) * 2 - 1) * scale
        return [x, *split_offset_mask(raw.to(device), G, 3)]
    off = (torch.rand(B, Ho, Wo, G, 9, 2, generator=g) * 2 - 1) * scale
    mask = torch.rand(B, Ho, Wo, G, 9, generator=g)
    return [x, off.to(device), mask.to(device)]


@pytest.mark.parametrize("B,H,W,Cin,G,stride,dilation,S,strided", [
    (1, 96, 160, 64, 8, 1, 1, None, True),    # L1 of a serving window
    (4, 12, 12, 64, 8, 1, 1, None, False),    # L3 of a training batch
    (2, 7, 9, 24, 4, 1, 1, None, False),      # CpG 6: the scalar path
    (2, 13, 11, 16, 8, 2, 1, None, True),     # stride 2
    (1, 9, 10, 32, 4, 1, 2, None, False),     # dilation 2
    (2, 17, 19, 64, 8, 1, 1, 2, True),        # shift bound 2, offsets +-6
])
def test_dcn_kernels_match_plain(cuda, B, H, W, Cin, G, stride, dilation, S,
                                 strided):
    """``dcn_forward`` and ``dcn_backward`` against their plain versions at
    ragged sizes, strided offset views and a shift bound: the forward within
    1e-4, the gradients of x, offset, mask and weight within 1e-4 x max|g|
    (3xTF32 products; grad x by atomics, summed in any order)."""
    from stif_tpu_torch.ops import (dcn_backward, dcn_backward_plain,
                                    dcn_forward, dcn_forward_plain)

    x, off, mask = _dcn_inputs(cuda, B, H, W, Cin, G, stride, dilation,
                               strided=strided)
    assert off.is_contiguous() != strided
    g = torch.Generator().manual_seed(1)
    w = (torch.randn(Cin, Cin, 3, 3, generator=g) / (3 * Cin ** 0.5)).to(cuda)
    b = torch.randn(Cin, generator=g).to(cuda)
    geo = (stride, 1, dilation, S)
    before = dcn_forward.launches, dcn_backward.launches
    out = dcn_forward(x, off, mask, w, b, *geo)
    want = dcn_forward_plain(x, off, mask, w, b, *geo)
    assert (out - want).abs().max().item() <= 1e-4
    cot = torch.randn_like(out)
    got = dcn_backward(cot, x, off, mask, w, *geo)
    torch.cuda.synchronize()
    assert (dcn_forward.launches, dcn_backward.launches) == (
        before[0] + 1, before[1] + 1)
    for g, w_ in zip(got, dcn_backward_plain(cot, x, off, mask, w, *geo)):
        assert g.shape == w_.shape
        assert (g - w_).abs().max().item() <= 1e-4 * w_.abs().max().item()


@pytest.mark.parametrize("Cin,G,Cout,k", [
    (16, 4, 80, 3),    # two column tiles: grad offset and mask by atomics
    (96, 1, 8, 3),     # a group wider than a chunk
    (12, 4, 3, 3),     # CpG 3, Cout 3: 4-byte copies, the scalar path
    (16, 2, 12, 5),    # a 5x5 kernel
])
def test_dcn_kernels_take_any_channels(cuda, Cin, G, Cout, k):
    """The padded and chunked shapes: the kernels against their plain
    versions (bars of ``test_dcn_kernels_match_plain``)."""
    from stif_tpu_torch.ops import (dcn_backward, dcn_backward_plain,
                                    dcn_forward, dcn_forward_plain)

    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 11, 13, Cin, generator=g).to(cuda)
    off = ((torch.rand(2, 11, 13, G, k * k, 2, generator=g) * 2 - 1)
           * 4).to(cuda)
    mask = torch.rand(2, 11, 13, G, k * k, generator=g).to(cuda)
    w = (torch.randn(Cout, Cin, k, k, generator=g) / (k * Cin ** 0.5)).to(cuda)
    geo = (1, k // 2, 1, None)
    out = dcn_forward(x, off, mask, w, None, *geo)
    want = dcn_forward_plain(x, off, mask, w, None, *geo)
    assert (out - want).abs().max().item() <= 1e-4
    cot = torch.randn_like(out)
    got = dcn_backward(cot, x, off, mask, w, *geo)
    for g_, w_ in zip(got, dcn_backward_plain(cot, x, off, mask, w, *geo)):
        assert (g_ - w_).abs().max().item() <= 1e-4 * w_.abs().max().item()


@pytest.mark.parametrize("bias", [True, False])
def test_deform_conv2d_on_the_card_matches_autograd_of_plain(cuda, bias):
    """The Function on the card (``dcn_forward``, then ``dcn_backward``)
    against autograd through the plain forward on the card, with and without
    a bias; the launches it makes: one forward, then one backward."""
    from stif_tpu_torch.ops import (dcn_backward, dcn_forward, deform_conv2d,
                                    deform_conv2d_plain)

    x, off, mask = _dcn_inputs(cuda, 2, 24, 40, 64, 8, strided=True)
    g = torch.Generator().manual_seed(1)
    w = (torch.randn(64, 64, 3, 3, generator=g) * 0.05).to(cuda)
    b = torch.randn(64, generator=g).to(cuda) if bias else None
    cot = torch.randn(2, 24, 40, 64, generator=g).to(cuda)
    grads = []
    for op in (deform_conv2d, deform_conv2d_plain):
        ins = [v.detach().clone().requires_grad_(True) for v in (x, off, mask,
                                                                 w)]
        bb = None if b is None else b.clone().requires_grad_(True)
        before = dcn_forward.launches, dcn_backward.launches
        y = op(*ins, bb, impl="patch")
        n_fwd = dcn_forward.launches - before[0]
        (y * cot).sum().backward()
        torch.cuda.synchronize()
        if op is deform_conv2d:
            assert n_fwd == 1
            assert (dcn_forward.launches, dcn_backward.launches) == (
                before[0] + 1, before[1] + 1)
        else:
            assert (dcn_forward.launches, dcn_backward.launches) == before
        grads.append([y.detach()] + [v.grad for v in ins]
                     + ([] if bb is None else [bb.grad]))
    for got, want in zip(*grads):
        assert (got - want).abs().max().item() <= 1e-4 * max(
            1.0, want.abs().max().item())


def test_dcn_forward_profile_is_one_kernel(cuda):
    """One ``deform_conv2d`` forward at L1 (96x160, nf 64, 8 groups) runs one
    kernel on the card, ``dcn_forward``: no cuBLAS GEMM, no column matrix,
    no copy of the weight."""
    from torch.profiler import ProfilerActivity, profile

    from stif_tpu_torch.ops import deform_conv2d

    x, off, mask = _dcn_inputs(cuda, 1, 96, 160, 64, 8, strided=True)
    w = torch.randn(64, 64, 3, 3, device=cuda) * 0.05
    b = torch.randn(64, device=cuda)
    with torch.no_grad():
        deform_conv2d(x, off, mask, w, b)  # builds and loads the kernels
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            deform_conv2d(x, off, mask, w, b)
            torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names and all("dcn_forward" in n for n in names), names
    assert not any("gemm" in n.lower() for n in names), names


def test_dcn_kernels_refuse_bad_inputs(cuda):
    """On the card the op launches the kernels or raises: fp16, an operand
    left on the CPU, a float64 weight, a non-contiguous x; no launch is made
    for them."""
    from stif_tpu_torch.ops import dcn_forward, deform_conv2d

    x, off, mask = _dcn_inputs(cuda, 1, 8, 8, 16, 4)
    w = torch.randn(8, 16, 3, 3, device=cuda)
    before = dcn_forward.launches
    with pytest.raises(ValueError, match="float32"):
        deform_conv2d(x.half(), off, mask, w)
    with pytest.raises(ValueError, match="float32"):
        deform_conv2d(x, off.cpu(), mask, w)
    with pytest.raises(ValueError, match="float32"):
        deform_conv2d(x, off, mask, w.double())
    with pytest.raises(ValueError, match="contiguous"):
        dcn_forward(x.transpose(1, 2), off, mask, w)
    assert dcn_forward.launches == before
    deform_conv2d(x, off, mask, w)
    assert dcn_forward.launches == before + 1


def test_model_on_the_card_launches_the_dcn_kernels(small_model):
    """A window of the small model launches the forward kernel once per DCN
    call (7 PCD pyramids of 6, both ConvLSTM directions in one batch) and
    agrees with the same model on the plain DCN."""
    from stif_tpu_torch.nn.dcn import set_dcn_kernel
    from stif_tpu_torch.ops import dcn_forward

    build, x, times = small_model
    model = build()
    before = dcn_forward.launches
    with torch.inference_mode():
        got = model(x, times)
    assert dcn_forward.launches == before + 42
    set_dcn_kernel(model, False)
    with torch.inference_mode():
        want = model(x, times)
    assert dcn_forward.launches == before + 42
    assert (got - want).abs().max().item() <= 1e-4


def test_constant_store_keys_per_card(cuda):
    """``cuda``, ``cuda:0`` and ``torch.device('cuda', 0)`` are one key of
    the per-bucket store while card 0 is current, and the constant lies on
    card 0; the CPU's copy and another card's are entries of their own."""
    from stif_tpu_torch.ops.constants import ConstantStore
    from stif_tpu_torch.ops.coords import _coord_np

    store = ConstantStore()
    torch.cuda.set_device(0)
    args = ((4, 6), None, True)
    a = store.get(_coord_np, *args, device="cuda")
    assert a.device == torch.device("cuda", 0)
    assert store.get(_coord_np, *args, device="cuda:0") is a
    assert store.get(_coord_np, *args, device=torch.device("cuda", 0)) is a
    c = store.get(_coord_np, *args, device="cpu")
    assert c.device.type == "cpu" and torch.equal(c, a.cpu())
    assert not a.is_inference() and not a.requires_grad
    assert set(store.stats()) == {"cuda:0", "cpu"}
    assert store.stats()["cuda:0"]["builds"] == 1
    if torch.cuda.device_count() > 1:
        b = store.get(_coord_np, *args, device="cuda:1")
        assert b is not a and b.device == torch.device("cuda", 1)
        assert store.stats()["cuda:1"]["builds"] == 1


@contextlib.contextmanager
def _sync_error():
    """CUDA's sync debug mode at "error" inside: a host-blocking call
    raises."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _checked(fn):
    def call(*args, **kwargs):
        with _sync_error():
            return fn(*args, **kwargs)
    return call


@pytest.mark.parametrize("mode", ["window", "local_ensemble", "test_mode",
                                  "stream", "render_pairs"])
def test_model_call_makes_no_host_sync_once_warm(small_model, mode):
    """After one call of a bucket has built its constants, the eager model
    call of each serving path makes no host-blocking call (sync debug mode
    "error" raises on any), and the frames equal the warm-up's bitwise.
    (A compiled pipeline runs no model call on a replay:
    ``test_compiled_replay_makes_no_host_sync`` checks the replays.)"""
    from stif_tpu_torch.runtime import InferencePipeline

    build, _, _ = small_model
    model = build()
    frames = np.random.default_rng(4).random((2, 8, 12, 3)).astype(
        np.float32)
    times = [0.0, 0.4, 1.0]
    pipe = InferencePipeline(model, bucket=4, compiled=False,
                             local_ensemble=mode == "local_ensemble",
                             test_mode=mode == "test_mode")
    if mode == "stream":
        warm = pipe.render_window(frames, times)
        staged = [pipe.stage(frames, times) for _ in range(2)]
        got = list(pipe.stream(staged, around_launch=_sync_error))
        for g in got:
            np.testing.assert_array_equal(g, warm)
        return
    if mode == "render_pairs":
        pairs = np.stack([frames, frames[::-1]])
        warm = pipe.render_pairs(pairs, times, chunk_size=100)
        for name in ("gen_feat", "decode_chunk_ab", "decode_chunk_cd"):
            setattr(model, name, _checked(getattr(model, name)))
        got = pipe.render_pairs(pairs, times, chunk_size=100)
    else:
        warm = pipe.render_window(frames, times)
        model.forward = _checked(model.forward)
        got = pipe.render_window(frames, times)
    np.testing.assert_array_equal(got, warm)


# ------------------------------------------------------ compiled programs

COMPILED_PATHS = ["window", "local_ensemble", "test_mode", "self_ensemble",
                  "sequence", "render_pairs", "tmnet"]


def _small_tmnet(cuda):
    from stif_tpu_torch.models import TMNet

    torch.manual_seed(0)
    model = TMNet(nf=16, groups=4, front_RBs=1, back_RBs=1)
    for p in model.parameters():  # the offset convs start at zero
        if p.abs().max() == 0:
            torch.nn.init.uniform_(p, -0.05, 0.05)
    return model.to(cuda).eval()


def _render(pipe, path, frames, times):
    """The frames of ``path`` through ``pipe``, as one array."""
    if path == "sequence":
        return np.stack(pipe.render_sequence(frames, n_times=len(times)))
    if path == "render_pairs":
        pairs = np.stack([frames[:2], frames[1:3]])
        return pipe.render_pairs(pairs, times, chunk_size=200)
    if path == "tmnet":
        return pipe.render_window_tmnet(frames, times)
    return pipe.render_window(frames[:2], times)


def _compiled_and_eager(small_model, path):
    from stif_tpu_torch.runtime import InferencePipeline

    build, _, _ = small_model
    model = (_small_tmnet(torch.device("cuda")) if path == "tmnet"
             else build())
    kw = {k: True for k in ("local_ensemble", "test_mode", "self_ensemble")
          if k == path}
    return (InferencePipeline(model, bucket=4, **kw),
            InferencePipeline(model, bucket=4, compiled=False, **kw))


@pytest.mark.parametrize("path", COMPILED_PATHS)
def test_compiled_equals_eager_on_the_card(small_model, path):
    """Each captured path replays to the eager frames bit for bit (max|d| =
    0): the first call (warm-up, capture, replay) and a replay; the
    self-ensemble's transpose makes a second bucket in the same pool."""
    comp, eager = _compiled_and_eager(small_model, path)
    frames = np.random.default_rng(5).random((3, 8, 12, 3)).astype(
        np.float32)
    times = [0.0, 0.4, 1.0]
    want = _render(eager, path, frames, times)
    first = _render(comp, path, frames, times)
    again = _render(comp, path, frames, times)
    assert np.abs(first - want).max() == 0
    assert np.abs(again - want).max() == 0
    assert comp.programs.captures == (2 if path == "self_ensemble" else 1)
    for stats in comp.programs.stats():
        assert stats["replays"] >= 2 and stats["pool_bytes"] >= 0


@pytest.mark.parametrize("path", COMPILED_PATHS)
def test_compiled_replay_makes_no_host_sync(small_model, path):
    """Once its bucket is captured, a path's replays (the static inputs'
    copies, the graph launch) make no host-blocking call (sync debug mode
    "error" raises on any), and no new capture."""
    comp, _ = _compiled_and_eager(small_model, path)
    frames = np.random.default_rng(6).random((3, 8, 12, 3)).astype(
        np.float32)
    times = [0.0, 0.4, 1.0]
    want = _render(comp, path, frames, times)
    comp.programs.run = _checked(comp.programs.run)
    got = _render(comp, path, frames, times)
    assert comp.programs.captures == (2 if path == "self_ensemble" else 1)
    np.testing.assert_array_equal(got, want)


def test_compiled_launches_count_replays(small_model):
    """A window's capture adds no launch; its eager warm-up and each replay
    add 3 SIREN, 42 ``dcn_forward`` and 8 ``grid_sample`` launches, the
    program's tally."""
    from stif_tpu_torch.ops import dcn_forward, grid_sample
    from stif_tpu_torch.runtime import InferencePipeline

    build, _, _ = small_model
    pipe = InferencePipeline(build(), bucket=4)
    frames = np.random.default_rng(7).random((2, 8, 12, 3)).astype(
        np.float32)

    def counts():
        return (siren_apply_fused.launches, dcn_forward.launches,
                grid_sample.launches)

    c0 = counts()
    pipe.render_window(frames, [0.0, 0.5])
    (program,) = pipe.programs.programs.values()
    assert program.launches == {siren_apply_fused: 3, dcn_forward: 42,
                                grid_sample: 8}
    assert counts() == (c0[0] + 6, c0[1] + 84, c0[2] + 16)
    for k in (1, 2):
        pipe.render_window(frames, [0.0, 0.5])
        assert counts() == (c0[0] + 6 + 3 * k, c0[1] + 84 + 42 * k,
                            c0[2] + 16 + 8 * k)


def test_compiled_sees_a_weight_reload(small_model):
    """Weights loaded in place after the capture keep their addresses: the
    next replay renders with them (the eager frames of the new weights,
    bitwise), with no new capture; a switch of the SIREN kernel captures
    anew."""
    from stif_tpu_torch.nn.siren import set_fused
    from stif_tpu_torch.runtime import InferencePipeline

    build, _, _ = small_model
    model = build()
    pipe = InferencePipeline(model, bucket=4)
    eager = InferencePipeline(model, bucket=4, compiled=False)
    frames = np.random.default_rng(8).random((2, 8, 12, 3)).astype(
        np.float32)
    times = [0.0, 0.5]
    before = pipe.render_window(frames, times)
    gen = torch.Generator().manual_seed(9)
    state = {k: v * (0.9 + 0.2 * torch.rand(v.shape, generator=gen)).to(
        v.device) for k, v in model.state_dict().items()}
    model.load_state_dict(state)
    got = pipe.render_window(frames, times)
    assert pipe.programs.captures == 1
    assert np.abs(got - eager.render_window(frames, times)).max() == 0
    assert np.abs(got - before).max() > 1e-3
    set_fused(model, False)
    try:
        plain = pipe.render_window(frames, times)
        assert pipe.programs.captures == 2
        assert np.abs(plain - eager.render_window(frames, times)).max() == 0
    finally:
        set_fused(model, True)


def test_capture_survives_a_program_in_a_garbage_cycle(small_model):
    """A pipeline left in a reference cycle still holds its captured graph
    until the collector frees it, and a graph destroyed in the middle of
    another capture invalidates that capture. The cache collects the
    garbage before it captures and keeps the collector off while it does,
    so a capture whose forward runs a collection still succeeds and
    replays the eager frames."""
    import gc

    from stif_tpu_torch.runtime import InferencePipeline

    build, _, _ = small_model
    frames = np.random.default_rng(11).random((2, 8, 12, 3)).astype(
        np.float32)
    times = [0.0, 0.5]
    old = InferencePipeline(build(), bucket=4)
    old.render_window(frames, times)
    old.cycle = old
    model = build()
    want = InferencePipeline(model, bucket=4, compiled=False).render_window(
        frames, times)
    forward = model.forward

    def collecting(*args, **kwargs):
        if torch.cuda.is_current_stream_capturing():
            gc.collect()  # as an automatic collection might, mid-capture
        return forward(*args, **kwargs)

    model.forward = collecting
    pipe = InferencePipeline(model, bucket=4)
    gc.disable()  # the cycle stays garbage until the capture
    try:
        del old
        got = pipe.render_window(frames, times)
    finally:
        gc.enable()
    assert pipe.programs.captures == 1
    assert np.abs(got - want).max() == 0


# ------------------------------------------------ compiled chunked decode

def _blocking_calls(fn):
    """``fn()`` and its host-blocking calls, counted by CUDA's sync debug
    mode at "warn" (one warning each; not the mode's own notice, given once
    a process, that it is a prototype)."""
    import warnings

    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return out, sum("synchroniz" in str(w.message)
                    and "prototype" not in str(w.message) for w in caught)


@pytest.mark.parametrize("case", ["b1", "b2_per_sample_times", "test_mode"])
@pytest.mark.parametrize("chunk", [500, 4096])
def test_compiled_chunked_equals_eager_on_the_card(small_model, case, chunk):
    """The decoder's four passes replayed as CUDA graphs give the eager
    decode bit for bit (max|d| = 0) on the first call and on a second one,
    which captures nothing, launches 3 SIREN kernels per chunk step, makes
    no host sync inside its replays (sync debug mode "error") and one
    blocking call in all (the frames to the host)."""
    from stif_tpu_torch.runtime import ChunkedDecoder

    build, x, times = small_model
    model = build()
    B = 2 if case == "b2_per_sample_times" else 1
    if B == 2:
        times = torch.tensor([[0.0, 0.6], [0.9, 0.2]], device="cuda")
    with torch.inference_mode():
        feat = model.gen_feat(x[:B])

    def decode(decoder):
        return decoder.decode(feat, x[:B], times, (32, 48),
                              hr_inp_upsample=case == "test_mode")

    want = decode(ChunkedDecoder(model, chunk, compiled=False))
    comp = ChunkedDecoder(model, chunk)
    first = decode(comp)
    assert comp.programs.captures == 4
    comp.programs.run = _checked(comp.programs.run)
    before = siren_apply_fused.launches
    again, blocking = _blocking_calls(lambda: decode(comp))
    steps = -(-32 * 48 // min(chunk, 32 * 48))
    assert siren_apply_fused.launches == before + 3 * steps
    assert comp.programs.captures == 4 and blocking == 1
    assert np.abs(first - want).max() == 0
    assert np.abs(again - want).max() == 0
    assert comp.stats()["held_bytes"] > 0
    for stats in comp.programs.stats():
        assert stats["pool_bytes"] >= 0


def test_compiled_render_pairs_keeps_its_decoder_on_the_card(small_model):
    """``render_pairs`` on a compiled pipeline keeps its decoder: the
    second call captures nothing and makes one blocking call; its frames
    equal an eager pipeline's bitwise."""
    from stif_tpu_torch.runtime import InferencePipeline

    build, _, _ = small_model
    model = build()
    comp = InferencePipeline(model, bucket=4)
    eager = InferencePipeline(model, bucket=4, compiled=False)
    pairs = np.random.default_rng(10).random((2, 2, 8, 12, 3)).astype(
        np.float32)
    times = [0.0, 0.4, 1.0]
    want = eager.render_pairs(pairs, times, chunk_size=300)
    first = comp.render_pairs(pairs, times, chunk_size=300)
    decoder = comp._chunked
    again, blocking = _blocking_calls(
        lambda: comp.render_pairs(pairs, times, chunk_size=300))
    assert comp._chunked is decoder and decoder.programs.captures == 4
    assert comp.programs.captures == 1 and blocking == 1
    assert np.abs(first - want).max() == 0
    assert np.abs(again - want).max() == 0


def test_compiled_chunked_on_a_card_that_is_not_current(small_model):
    """A compiled decoder on ``cuda:1`` while ``cuda:0`` is current: its
    buffers, copies, captures and replays follow its own card, so a decode
    and its replay equal an eager decoder's on that card bitwise."""
    from stif_tpu_torch.runtime import ChunkedDecoder

    cards = _cards(2)
    build, x, times = small_model
    torch.cuda.set_device(0)
    model = build().to(cards[1])
    xs, ts = x[:1].to(cards[1]), times.to(cards[1])
    with torch.inference_mode():
        feat = model.gen_feat(xs)
    want = ChunkedDecoder(model, 500, device=cards[1],
                          compiled=False).decode(feat, xs, ts, (32, 48))
    comp = ChunkedDecoder(model, 500, device=cards[1])
    for _ in range(2):
        got = comp.decode(feat, xs, ts, (32, 48))
        assert np.abs(got - want).max() == 0
    assert torch.cuda.current_device() == 0
    assert comp.programs.captures == 4


# ------------------------------------------------- compiled train step

TRAIN_NET = dict(which_model_G="LIIF", nf=8, nframes=6, groups=2,
                 front_RBs=1, back_RBs=1, rgb_skip="bicubic")


def _train_model(cuda, tmp_path, compiled):
    from stif_tpu_torch.train.video_sr_model import VideoSRModel

    torch.backends.cudnn.allow_tf32 = False
    opt = {"network_G": dict(TRAIN_NET),
           "path": {"models": str(tmp_path / f"models_{compiled}")},
           "train": dict(lr_G=1e-4, warmup_iter=-1, T_period=[100],
                         restarts=[], restart_weights=[], grad_clip=1e6,
                         ema_decay=0.999)}
    m = VideoSRModel(opt, device=cuda, compiled=compiled)
    b = _train_batch(32, 0)
    m.init_params(b["LQs"], b["times"], seed=3)
    return m


def _train_batch(gt, seed):
    rng = np.random.default_rng(seed)
    return {"LQs": rng.random((2, 2, 8, 8, 3)).astype(np.float32),
            "GT": rng.random((2, 2, gt, gt, 3)).astype(np.float32),
            "times": np.asarray([[0.0, 0.5], [1.0, 0.25]], np.float32)}


def test_compiled_train_step_on_the_card(cuda, tmp_path):
    """The step captured once per bucket (x4: GT 32, x2: GT 16) and
    replayed: three steps (x4, x2, x4) against three eager ones from the
    same init, loss rtol 1e-4 and grad norm rtol 1e-3 (the DCN backward's
    atomics rule out bitwise); the third step, a bucket's second visit,
    captures nothing, and its ``feed_data`` and replay run under the sync
    debug mode "error"; ``optimize_parameters`` makes one blocking call,
    its logs' fetch."""
    from stif_tpu_torch.ops import dcn_backward, dcn_forward, grid_sample

    eager = _train_model(cuda, tmp_path, False)
    comp = _train_model(cuda, tmp_path, None)
    assert comp.programs is not None and eager.programs is None
    for gt, seed in ((32, 0), (16, 1), (32, 2)):
        batch = _train_batch(gt, seed)
        eager.feed_data(batch)
        before = (dcn_forward.launches, dcn_backward.launches,
                  grid_sample.launches)
        want = eager.optimize_parameters()
        per_step = (dcn_forward.launches - before[0],
                    dcn_backward.launches - before[1],
                    grid_sample.launches - before[2])
        if seed < 2:
            comp.feed_data(batch)
            got = comp.optimize_parameters()
        else:
            with _sync_error():
                comp.feed_data(batch)
                metrics = comp.run_step()
            got = {k: v.item() for k, v in metrics.items()}
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-3)
    assert comp.programs.captures == 2
    assert sorted(st["replays"] for st in comp.programs.stats()) == [1, 2]
    # a replay tallies the launches of the whole step, the backward's (run
    # from autograd's thread) and the remat's recomputation too: 8 gathers
    # of the decode pass and 8 again
    assert per_step[0] > per_step[1] > 0 and per_step[2] == 16
    for st in comp.programs.stats():
        assert st["launches"] == {"dcn_forward": per_step[0],
                                  "dcn_backward": per_step[1],
                                  "grid_sample": per_step[2]}
    comp.feed_data(_train_batch(16, 3))
    _, blocking = _blocking_calls(comp.optimize_parameters)
    assert blocking == 1 and comp.programs.captures == 2
    # each replay marks the step's four phases in its program's table
    for st in comp.programs.stats():
        assert {k: v["n"] for k, v in st["stages"].items()} == {
            k: st["replays"] for k in ("train.forward", "train.backward",
                                       "train.update", "train.ema")}


def test_compiled_train_step_resume_on_the_card(cuda, tmp_path):
    """``resume_training`` copies params, moments, count and EMA into the
    tensors the step's graph writes: the state after it is the saved one
    bitwise, and the next step replays the program (no capture) and gives
    the loss the uninterrupted run gave after the save (rtol 1e-5)."""
    m = _train_model(cuda, tmp_path, None)
    for seed in range(2):
        m.feed_data(_train_batch(32, seed))
        m.optimize_parameters()
    assert m.save() == 2
    saved = ({k: v.clone() for k, v in m.net.state_dict().items()},
             [v.clone() for v in m.optimizer.state()[1:]],
             {k: v.clone() for k, v in m.ema_params.items()})
    m.feed_data(_train_batch(32, 2))
    loss3 = m.optimize_parameters()["loss"]
    assert m.resume_training() == 2
    params, opt_state, ema = saved
    assert all(torch.equal(v, params[k])
               for k, v in m.net.state_dict().items())
    # the gradients (in ``state``) are the last step's, not checkpointed
    n = len(m.optimizer.params)
    live = m.optimizer.state()[1:]
    assert all(torch.equal(a, b) for i, (a, b) in
               enumerate(zip(live, opt_state)) if not n <= i < 2 * n)
    assert float(m.optimizer.count) == 2.0
    assert all(torch.equal(v, ema[k]) for k, v in m.ema_params.items())
    m.feed_data(_train_batch(32, 2))
    again = m.optimize_parameters()["loss"]
    np.testing.assert_allclose(again, loss3, rtol=1e-5)
    assert m.programs.captures == 1
    assert m.programs.stats()[0]["replays"] == 4


# ------------------------------------------------ stage marks and spans

def _stages(pipe):
    (st,) = pipe.programs.stats()
    return st


def test_stage_marks_match_cuda_events(small_model, monkeypatch):
    """An eager window's ``encode`` and ``decode`` totals in the eager
    table against CUDA events recorded on the same stream just outside the
    stages' mark kernels: within 2 % or 50 us. At LR 64x96 the device, not
    the host's launches, sets the pace, so the events and the marks it
    brackets run back to back: on a host-bound call the device would wait
    for the Python between an event and its mark, which only one of the
    two clocks sees."""
    from stif_tpu_torch.utils import trace

    build, _, t = small_model
    model = build()
    x = torch.rand(1, 2, 64, 96, 3, device=t.device)
    events = {}
    real_open, real_close = trace.Marks.open, trace.Marks.close

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def opened(self, slot):
        if trace.STAGES[slot] in ("encode", "decode"):
            events[trace.STAGES[slot]] = [event()]
        real_open(self, slot)

    def closed(self, slot):
        real_close(self, slot)
        if trace.STAGES[slot] in ("encode", "decode"):
            events[trace.STAGES[slot]].append(event())

    with torch.inference_mode():
        model(x, t)  # constants, kernels, library
        torch.cuda.synchronize()
        before = trace.eager_stats(x.device)["stages"]
        monkeypatch.setattr(trace.Marks, "open", opened)
        monkeypatch.setattr(trace.Marks, "close", closed)
        model(x, t)
        torch.cuda.synchronize()
        after = trace.eager_stats(x.device)["stages"]
    for stage in ("encode", "decode"):
        assert after[stage]["n"] == before[stage]["n"] + 1
        marked = after[stage]["device_ms"] - before[stage]["device_ms"]
        timed = events[stage][0].elapsed_time(events[stage][1])
        assert abs(marked - timed) <= max(0.02 * timed, 0.05), (
            stage, marked, timed)


def test_stage_marks_count_the_replays_of_a_stream(small_model):
    """A double-buffered stream of 6 windows through one program: every
    stage's count equals the replays, each host span counts the windows
    after the first, and the graph's node count is read."""
    from stif_tpu_torch.runtime import InferencePipeline

    build, _, _ = small_model
    pipe = InferencePipeline(build(), bucket=4)
    frames = np.random.default_rng(8).random((2, 8, 12, 3)).astype(
        np.float32)
    list(pipe.stream(pipe.stage(frames, [0.0, 0.5]) for _ in range(6)))
    st = _stages(pipe)
    assert st["replays"] == 6
    assert set(st["stages"]) == {
        "encode", "encode.front", "encode.pcd", "encode.convlstm",
        "encode.trunk", "decode", "decode.prep", "decode.ab", "decode.cd"}
    assert all(row["n"] == 6 and row["device_ms"] > 0
               for row in st["stages"].values())
    assert st["stages"]["encode"]["device_ms"] >= sum(
        st["stages"][k]["device_ms"] for k in st["stages"]
        if k.startswith("encode."))
    assert {k: v["n"] for k, v in st["host"].items()} == {
        k: 5 for k in ("stage.pad", "stage.upload", "launch.copy_in",
                       "launch.replay", "fetch.wait", "fetch.copy")}
    assert isinstance(st["graph_nodes"], int) and st["graph_nodes"] > 100


def _profiled_replay(pipe, frames, times):
    """The Chrome-trace events of one replayed window, with nothing else
    queued."""
    import json
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pipe.render_window(frames, times)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/trace.json"
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def test_replay_range_opens_before_its_first_mark(small_model):
    """In a profiler trace of one replayed window, the ``launch.replay``
    range opens before the window's first ``stage_mark_kernel``, on the
    same clock, and the kernel runs twice per stage."""
    from stif_tpu_torch.runtime import InferencePipeline

    build, _, _ = small_model
    pipe = InferencePipeline(build(), bucket=4)
    frames = np.random.default_rng(9).random((2, 8, 12, 3)).astype(
        np.float32)
    for _ in range(2):
        pipe.render_window(frames, [0.0, 0.5])
    events = _profiled_replay(pipe, frames, [0.0, 0.5])
    (replay,) = [e for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"
                 and e.get("name") == "launch.replay"]
    marks = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "kernel"
             and "stage_mark_kernel" in e.get("name", "")]
    assert len(marks) == 2 * len(_stages(pipe)["stages"])
    assert replay["ts"] < min(e["ts"] for e in marks)


def test_marks_change_nothing_a_replayed_window_computes(small_model,
                                                        monkeypatch):
    """A window captured with its stage marks equals, bitwise, one
    captured with the marks made inert: that graph holds no
    ``stage_mark_kernel``, two nodes fewer per stage, and its stages
    table stays empty."""
    from stif_tpu_torch.runtime import InferencePipeline
    from stif_tpu_torch.utils import trace

    build, _, _ = small_model
    frames = np.random.default_rng(10).random((2, 8, 12, 3)).astype(
        np.float32)
    times = [0.0, 0.5]
    marked_pipe = InferencePipeline(build(), bucket=4)
    want = marked_pipe.render_window(frames, times)
    marked = _stages(marked_pipe)
    with monkeypatch.context() as inert:
        inert.setattr(trace.Marks, "open", lambda self, slot: None)
        inert.setattr(trace.Marks, "close", lambda self, slot: None)
        pipe = InferencePipeline(build(), bucket=4)
        got = pipe.render_window(frames, times)
        events = _profiled_replay(pipe, frames, times)
    st = _stages(pipe)
    np.testing.assert_array_equal(got, want)
    assert not any("stage_mark_kernel" in e.get("name", "") for e in events)
    assert st["stages"] == {} and st["replays"] == 2
    assert marked["graph_nodes"] - st["graph_nodes"] == 2 * len(
        marked["stages"])


# ------------------------------------------------------------ grid_sample

def _gs_want(x, grid, mode, padding_mode, align_corners):
    """``F.grid_sample`` + ``.contiguous()`` on ATen's own kernel: cuDNN,
    which ``F.grid_sample`` takes for bilinear, zero padding and
    ``align_corners=True``, is turned off."""
    from stif_tpu_torch.ops import grid_sample_plain

    with torch.backends.cudnn.flags(enabled=False):
        return grid_sample_plain(x, grid, mode, padding_mode, align_corners)


def _gs_grid(rng, n, q, h, w, align_corners, device):
    """(n, q, 2) points in [-1.3, 1.3], a third of them at exact half-pixel
    source positions in x and another third in y (``h - 1`` or ``w - 1``
    a power of two under ``align_corners``, else ``h`` or ``w``)."""
    g = rng.uniform(-1.3, 1.3, (n, q, 2))
    for axis, size, sl in ((0, w, slice(0, None, 3)),
                           (1, h, slice(1, None, 3))):
        k = rng.integers(-1, size, g[:, sl, axis].shape) + 0.5
        g[:, sl, axis] = ((2 * k / (size - 1) - 1) if align_corners
                          else ((2 * k + 1) / size - 1))
    return torch.tensor(g, dtype=torch.float32, device=device)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("c", [3, 64, 198, 200])
@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_kernel_matches_aten(cuda, rng, c, mode, padding_mode,
                                         align_corners):
    """The kernel against ``F.grid_sample`` + ``.contiguous()`` bitwise, in
    the decoder's layouts: B 1 and nt x B (3 x 2) with a batch broadcast
    source (stride 0), a channel slice (pixel stride 2c, offset c), flat
    and 2-D grids, ragged query counts; points outside [-1, 1] and on
    exact half-pixel positions."""
    from stif_tpu_torch.ops import grid_sample

    h, w = (9, 17) if align_corners else (8, 16)
    base = torch.tensor(rng.standard_normal((2, h, w, 2 * c)),
                        dtype=torch.float32, device=cuda)
    sources = {
        "contiguous": base[:1, ..., :c].contiguous(),
        "broadcast": base[:2, ..., :c].contiguous().expand(3, 2, h, w, c)
        .reshape(6, h, w, c),
        "batch_stride_0": base[:1, ..., :c].contiguous().expand(6, h, w, c),
        "channel_slice": base[..., c:],
    }
    for name, x in sources.items():
        n = x.shape[0]
        for shape in ((n, 1000, 2), (n, 37, 29, 2)):
            q = int(np.prod(shape[1:-1]))
            grid = _gs_grid(rng, n, q, h, w, align_corners, cuda)
            grid = grid.reshape(shape)
            before = grid_sample.launches
            got = grid_sample(x, grid, mode=mode, padding_mode=padding_mode,
                              align_corners=align_corners)
            assert grid_sample.launches == before + 1
            want = _gs_want(x, grid, mode, padding_mode, align_corners)
            assert got.shape == want.shape and got.is_contiguous()
            mismatch = (_bits(got) != _bits(want)).sum().item()
            assert mismatch == 0, (name, shape, mismatch,
                                   (got - want).abs().max().item())


def test_grid_sample_kernel_reads_strided_grids(cuda, rng):
    """A grid view with a negative stride (``flip``) and one of stride 0
    over the batch, as the decoder hands them over, bitwise."""
    from stif_tpu_torch.ops import grid_sample

    x = torch.tensor(rng.standard_normal((3, 12, 20, 198)),
                     dtype=torch.float32, device=cuda)
    yx = _gs_grid(rng, 1, 4097, 12, 20, False, cuda)
    for grid in (yx.flip(-1).expand(3, 4097, 2), yx.expand(3, 4097, 2)):
        got = grid_sample(x, grid)
        assert torch.equal(_bits(got), _bits(_gs_want(x, grid, "bilinear",
                                                       "zeros", False)))


def test_grid_sample_decode_gradients_are_the_plain_ops(small_model,
                                                         monkeypatch):
    """A decode under grad (plain SIREN) through the kernel's autograd
    route against one through ``F.grid_sample``'s: the gradients of the
    sources (features, frames) and, through the warp grids, of
    ``flow_imnet``'s weights. ATen's backward scatters the source's
    gradient by atomics, in any order: rtol 1e-5 of each gradient's
    largest."""
    import stif_tpu_torch.models.luna_tokis as luna_tokis
    from stif_tpu_torch.ops import grid_sample, grid_sample_plain
    from stif_tpu_torch.ops.precision import round_to

    build, x, times = small_model
    model = build(fused=False)
    with torch.no_grad():
        feat0 = model.gen_feat(x)

    def plain(v, g, mode="bilinear", padding_mode="zeros",
              align_corners=False, source_dtype=None):
        if mode == "bilinear":
            v = round_to(v, source_dtype)
        return grid_sample_plain(v, g, mode, padding_mode, align_corners)

    def grads():
        model.zero_grad()
        feat = feat0.clone().requires_grad_(True)
        inp = x.clone().requires_grad_(True)
        out = model.decode(feat, inp, times)
        w = torch.linspace(-1, 1, out.numel(), device=out.device)
        (out.reshape(-1) * w).sum().backward()
        return [feat.grad, inp.grad] + [
            p.grad for p in model.flow_imnet.parameters()]

    # 8 gathers in the forward, 8 again where the backward recomputes the
    # decode pass (remat)
    before = grid_sample.launches
    got = grads()
    assert grid_sample.launches == before + 16
    with monkeypatch.context() as m:
        m.setattr(luna_tokis, "grid_sample", plain)
        want = grads()
    assert grid_sample.launches == before + 16
    for a, b in zip(got, want):
        scale = b.abs().max().item()
        assert scale > 0
        assert (a - b).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_grid_sample_grid_gradient_is_atens(cuda, rng, mode):
    """The op under autograd: the grid's gradient is ATen's bitwise (one
    thread a point); the source's, scattered by atomics, within 1e-6 of
    its largest."""
    from stif_tpu_torch.ops import grid_sample, grid_sample_plain

    x0 = torch.tensor(rng.standard_normal((2, 10, 14, 64)),
                      dtype=torch.float32, device=cuda)
    g0 = _gs_grid(rng, 2, 3000, 10, 14, False, cuda)
    w = torch.tensor(rng.standard_normal((2, 3000, 64)), dtype=torch.float32,
                     device=cuda)
    res = []
    for route in (grid_sample, grid_sample_plain):
        x = x0.clone().requires_grad_(True)
        g = g0.clone().requires_grad_(True)
        (route(x, g, mode) * w).sum().backward()
        res.append((x.grad, g.grad))
    (gx, gg), (wx, wg) = res
    assert torch.equal(_bits(gg), _bits(wg))
    assert (gx - wx).abs().max().item() <= 1e-6 * wx.abs().max().item()


def test_grid_sample_kernel_refuses_bad_inputs(cuda):
    """A dtype other than float32 and a non-unit channel stride raise; so
    does a grid on another device; nothing falls back."""
    from stif_tpu_torch.ops import grid_sample

    x = torch.rand(1, 6, 8, 16, device=cuda)
    g = torch.rand(1, 50, 2, device=cuda) * 2 - 1
    before = grid_sample.launches
    for bad in (x.double(), x.half(), x.to(torch.bfloat16)):
        with pytest.raises(ValueError, match="float32"):
            grid_sample(bad, g)
    with pytest.raises(ValueError, match="channel stride"):
        grid_sample(x[..., ::2], g)
    with pytest.raises(ValueError, match="channel stride"):
        grid_sample(x.permute(0, 3, 1, 2).permute(0, 2, 1, 3), g)
    with pytest.raises(ValueError, match="grid on"):
        grid_sample(x, g.cpu())
    assert grid_sample.launches == before


# ------------------------------------- STIF's arbitrary-scale architecture

def _liif_train(cuda):
    """``LIIF_train`` at nf 16, its DCN offset convs drawn (they start at
    zero), on the card."""
    from stif_tpu_torch.models.factory import define_g

    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    model = define_g({"network_G": {"which_model_G": "LIIF_train", "nf": 16,
                                    "groups": 4, "front_RBs": 1,
                                    "back_RBs": 1}})
    for p in model.parameters():
        if p.abs().max() == 0:
            torch.nn.init.uniform_(p, -0.05, 0.05)
    return model.to(cuda).eval()


def test_compiled_liif_train_equals_eager_on_the_card(cuda):
    """``InferencePipeline`` serving ``LunaTokisTrain``: the replayed window
    equals the eager one bit for bit, first call and replay, one capture;
    its graph holds 3 SIREN launches, each replay adds them, and a profiled
    replay runs ``siren_fused_kernel`` 3 times."""
    from stif_tpu_torch.runtime import InferencePipeline

    model = _liif_train(cuda)
    comp = InferencePipeline(model, bucket=4)
    eager = InferencePipeline(model, bucket=4, compiled=False)
    frames = np.random.default_rng(11).random((2, 8, 12, 3)).astype(
        np.float32)
    times = [0.0, 0.4, 1.0]
    want = eager.render_window(frames, times)
    got = [comp.render_window(frames, times) for _ in range(2)]
    assert want.shape == (3, 32, 48, 3)
    assert max(np.abs(g - want).max() for g in got) == 0
    (program,) = comp.programs.programs.values()
    assert comp.programs.captures == 1
    assert program.launches[siren_apply_fused] == 3
    before = siren_apply_fused.launches
    events = _profiled_replay(comp, frames, times)
    assert siren_apply_fused.launches == before + 3
    assert sum(1 for e in events if e.get("cat") == "kernel"
               and "siren_fused_kernel" in e.get("name", "")) == 3


@pytest.mark.parametrize("name", ["train_feat", "train_flow",
                                  "train_encode"])
def test_kernel_matches_plain_at_a_720p_window(cuda, rng, name):
    """Each ``LIIF_train`` net at the rows of a x4 720p window at 8 times
    (LR 192x320: 8 x 983,040), its fields laid out as the model hands them
    over, against the plain SIREN time by time: 1e-4."""
    splits, widths = ZOO_NETS[name]
    ws, bs = _net(rng, splits, widths, cuda)
    torch.manual_seed(0)
    xs = _zoo_fields(name, 8, 768 * 1280, cuda)
    got = siren_apply_fused(xs, ws, bs)
    torch.cuda.synchronize()
    assert got.shape == (8, 768 * 1280, widths[-1])
    worst = max((got[t] - siren_apply_fused_plain([x[t] for x in xs], ws,
                                                  bs)).abs().max().item()
                for t in range(8))
    assert worst <= 1e-4
