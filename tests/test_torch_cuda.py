"""The port's CUDA kernel on the card: builds, agrees with its plain
version, and raises rather than falling back. Marked ``cuda``; skipped
where there is no GPU. Needs no JAX: on a GPU host without it, run
``python -m pytest tests/test_torch_cuda.py -q --noconftest``."""

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
    of two, 3 launches per chunk step."""
    from stif_tpu_torch.runtime import ChunkedDecoder

    build, x, times = small_model
    model = build()
    with torch.inference_mode():
        feat = model.gen_feat(x)
        want = model.decode(feat, x, times).cpu().numpy()
    before = siren_apply_fused.launches
    got = ChunkedDecoder(model, chunk).decode(feat, x, times, (32, 48))
    steps = -(-32 * 48 // min(chunk, 32 * 48))
    assert siren_apply_fused.launches == before + 3 * steps
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
    memory) equals the back-to-back windows bitwise, 3 launches per pair."""
    from stif_tpu_torch.runtime import InferencePipeline

    build, _, _ = small_model
    pipe = InferencePipeline(build(), bucket=4)
    frames = np.random.default_rng(1).random((5, 8, 12, 3)).astype(
        np.float32)
    before = siren_apply_fused.launches
    got = pipe.render_sequence(frames, n_times=3)
    assert siren_apply_fused.launches == before + 12
    for i, out in enumerate(got):
        want = pipe.render_window(frames[i:i + 2], [0.0, 1 / 3, 2 / 3])
        np.testing.assert_array_equal(out, want)


def _cards(n):
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA GPUs")
    return [torch.device("cuda", i) for i in range(n)]


def test_pipeline_on_a_card_that_is_not_current(small_model):
    """A pipeline on ``cuda:1`` while ``cuda:0`` is current: its events and
    copy stream follow its own card, so the double-buffered frames equal
    the back-to-back ones bitwise and those of a pipeline on ``cuda:0``."""
    from stif_tpu_torch.runtime import InferencePipeline

    cards = _cards(2)
    build, _, _ = small_model
    torch.cuda.set_device(0)
    frames = np.random.default_rng(2).random((5, 48, 64, 3)).astype(
        np.float32)
    times = [0.0, 1 / 3, 2 / 3]
    ref = InferencePipeline(build(), bucket=4, device=cards[0])
    pipe = InferencePipeline(build(), bucket=4, device=cards[1])
    got = pipe.render_sequence(frames, n_times=3)
    assert torch.cuda.current_device() == 0
    for i, out in enumerate(got):
        np.testing.assert_array_equal(
            out, pipe.render_window(frames[i:i + 2], times))
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
