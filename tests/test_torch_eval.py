"""The port's eval harness, metrics and synthetic data on the CPU.

The metrics and the scene renderer are the port's own copies of numpy code:
they must give the JAX package's values exactly (same arithmetic). The four
eval protocols are held against ``stif_tpu.runtime.eval`` with both handed
the *port's* pipeline on the same rendered folders, so what is compared is
the harness (LR degradation, window and ground-truth indexing, metrics):
PSNR within 1e-3 dB and SSIM within 1e-5 (the two packages make the LR
frames with different bicubic code, equal to about 1e-6).
"""

import dataclasses

import cv2
import numpy as np
import pytest
import torch

from stif_tpu.data import synthetic as j_synthetic
from stif_tpu.runtime import eval as j_eval
from stif_tpu.utils import metrics as j_metrics

from stif_tpu_torch.data import synthetic
from stif_tpu_torch.models import LunaTokis
from stif_tpu_torch.runtime import InferencePipeline
from stif_tpu_torch.runtime import eval as p_eval
from stif_tpu_torch.utils import metrics
import torch_parity  # noqa: F401  (caps PyTorch's threads)

CFG = dict(nf=8, nframes=6, groups=2, front_RBs=1, back_RBs=1,
           rgb_skip=True, rgb_skip_bicubic=True)


# ------------------------------------------------------------------ metrics

def _images(rng, shape=(40, 48, 3)):
    a = rng.random(shape)
    return a, np.clip(a + 0.05 * rng.standard_normal(shape), 0, 1)


@pytest.mark.parametrize("name", ["calculate_psnr", "calculate_ssim",
                                  "ssim_torch", "ssim_matlab", "msssim"])
def test_image_metric(rng, name):
    a, b = _images(rng, (176, 192, 3) if name == "msssim" else (40, 48, 3))
    if name.startswith("calculate"):
        a, b = a * 255, b * 255
    want = getattr(j_metrics, name)(a, b)
    got = getattr(metrics, name)(a, b)
    assert np.isfinite(got) and got == want


def test_metric_shapes(rng):
    a, b = _images(rng)
    assert metrics.calculate_ssim(a[..., 0], b[..., 0]) == \
        j_metrics.calculate_ssim(a[..., 0], b[..., 0])
    assert metrics.calculate_psnr(a, a) == float("inf")
    with pytest.raises(ValueError):
        metrics.calculate_ssim(a, b[:-1])
    assert metrics.ssim_torch(a, b, full=True) == \
        j_metrics.ssim_torch(a, b, full=True)


@pytest.mark.parametrize("name", ["rgb2ycbcr", "bgr2ycbcr", "ycbcr2rgb"])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_colour_conversion(rng, name, dtype):
    img = rng.random((9, 11, 3))
    img = (img * 255).astype(np.uint8) if dtype == "uint8" else \
        img.astype(np.float32)
    kw = {} if name == "ycbcr2rgb" else {"only_y": False}
    want = getattr(j_metrics, name)(img, **kw)
    got = getattr(metrics, name)(img, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if name != "ycbcr2rgb":
        np.testing.assert_array_equal(getattr(metrics, name)(img),
                                      getattr(j_metrics, name)(img))


def test_modcrop_tensor2img(rng):
    img = rng.random((13, 18, 3)).astype(np.float32) * 1.2 - 0.1
    assert metrics.modcrop(img, 4).shape == (12, 16, 3)
    assert metrics.modcrop(img[..., 0], 4).shape == (12, 16)
    np.testing.assert_array_equal(metrics.tensor2img(img),
                                  j_metrics.tensor2img(img))


# ---------------------------------------------------------------- synthetic

@pytest.mark.parametrize("family", ["default", "occlusion", "lighting"])
def test_render_sequence(family):
    want = j_synthetic.render_sequence(77, 3, (24, 32), family=family)
    got = synthetic.render_sequence(77, 3, (24, 32), family=family)
    assert got.shape == (3, 24, 32, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_sample_scene_and_crop():
    want = j_synthetic.sample_scene(np.random.default_rng(5))
    got = synthetic.sample_scene(np.random.default_rng(5))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(
        synthetic.render_frame(got, 1.5, (10, 12), origin=(3.0, 4.5)),
        j_synthetic.render_frame(want, 1.5, (10, 12), origin=(3.0, 4.5)))


@pytest.mark.parametrize("writer", ["render_eval_folders",
                                    "render_eval_suite"])
def test_eval_folder_writers(tmp_path, writer):
    kw = (dict(n_scenes=2) if writer == "render_eval_folders"
          else dict(n_per_family=1, families=("default", "lighting")))
    kw.update(n_frames=2, size=(16, 24))
    a = getattr(synthetic, writer)(str(tmp_path / "port"), **kw)
    b = getattr(j_synthetic, writer)(str(tmp_path / "jax"), **kw)
    got, want = p_eval._load_frames, j_eval._load_frames
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 2
    for name in names:
        np.testing.assert_array_equal(got(f"{a}/{name}"), want(f"{b}/{name}"))
    # idempotent: a second call leaves the files alone
    before = (tmp_path / "port" / names[0] / "000.png").stat().st_mtime_ns
    getattr(synthetic, writer)(str(tmp_path / "port"), **kw)
    assert (tmp_path / "port" / names[0] / "000.png").stat().st_mtime_ns \
        == before


# ------------------------------------------------------------ eval harness

@pytest.fixture(scope="module")
def gt_root(tmp_path_factory):
    """Two 9-frame 64x96 scenes; with 70x100 frames the crops matter."""
    root = tmp_path_factory.mktemp("gt")
    return synthetic.render_eval_folders(str(root), n_scenes=2, n_frames=9,
                                         size=(70, 100), seed0=123)


def _pipeline(scale):
    torch.manual_seed(0)
    return InferencePipeline(LunaTokis(**CFG), scale=scale, bucket=4,
                             device="cpu")


def _assert_same(got: p_eval.EvalResult, want: j_eval.EvalResult):
    got, want = dataclasses.asdict(got), dataclasses.asdict(want)
    assert got.keys() == want.keys()
    for key, atol in (("psnr", 1e-3), ("ssim", 1e-5), ("psnr_by_time", 1e-3),
                      ("ssim_by_time", 1e-5)):
        assert got[key].keys() == want[key].keys()
        for k in want[key]:
            assert abs(got[key][k] - want[key][k]) <= atol, (key, k)
    np.testing.assert_allclose(got["per_time_psnr"], want["per_time_psnr"],
                               atol=1e-3)
    assert abs(got["mid_psnr"] - want["mid_psnr"]) <= 1e-3
    assert abs(got["mid_ssim"] - want["mid_ssim"]) <= 1e-5


@pytest.mark.parametrize("protocol", ["eval_space_time_sr", "eval_adobe_4x",
                                      "eval_adobe_liif4x",
                                      "eval_temporal_x8"])
def test_protocol_matches_jax_harness(gt_root, tmp_path, protocol):
    adobe = "adobe" in protocol
    pipe = _pipeline(8 if adobe else 4)
    kw = dict(downscale=1 / 8) if adobe else {}
    p_kw, j_kw = dict(kw), dict(kw)
    if adobe:
        p_kw.update(logfile=str(tmp_path / "port.log"), epoch_id=1, iter_id=2)
        j_kw.update(logfile=str(tmp_path / "jax.log"), epoch_id=1, iter_id=2)
    got = getattr(p_eval, protocol)(pipe, gt_root, **p_kw)
    want = getattr(j_eval, protocol)(pipe, gt_root, **j_kw)
    assert sorted(got.psnr) == ["scene0", "scene1"]
    assert all(np.isfinite(v) for v in got.psnr.values())
    _assert_same(got, want)
    assert abs(got.mean_psnr - want.mean_psnr) <= 1e-3
    assert abs(got.mean_ssim - want.mean_ssim) <= 1e-5
    if protocol == "eval_space_time_sr":
        assert set(got.psnr_by_time) == {0.5, 0.0} and got.avg_time_s > 0
    if protocol == "eval_temporal_x8":
        assert len(got.per_time_psnr) == 8
    if adobe:
        p_line = (tmp_path / "port.log").read_text().split("Epoch")[1]
        assert "[1/2]" in p_line and "Val_PSNR" in p_line
        assert p_line.split("Val_PSNR")[1] == (
            tmp_path / "jax.log").read_text().split("Val_PSNR")[1]


def test_folders_argument(gt_root):
    got = p_eval.eval_space_time_sr(_pipeline(4), gt_root,
                                    folders=["scene1"], times=(0.5,),
                                    y_channel=False)
    assert list(got.psnr) == ["scene1"] and list(got.psnr_by_time) == [0.5]


def test_score_in_memory_clip():
    """The private clip scorer takes frames as an array (no files)."""
    clip = synthetic.render_sequence(5, 5, (32, 48))
    scores, seconds, calls = p_eval._score_space_time_sr(_pipeline(4), clip)
    assert calls == 2 and seconds > 0
    assert [t for t, _, _ in scores] == [0.5, 0.0, 0.5, 0.0]
    assert all(np.isfinite(p) and 0 < s <= 1 for _, p, s in scores)


# ---------------------------------------------------------- TMNet protocols

TM_CFG = dict(nf=8, groups=2, front_RBs=1, back_RBs=1)


@pytest.fixture(scope="module")
def tmnet_pipes():
    """The JAX pipeline around the JAX TMNet and the port's pipeline around
    the port's TMNet, on the same converted parameters (offsets perturbed)."""
    import jax.numpy as jnp

    from stif_tpu.models import TMNet as JTMNet
    from stif_tpu.runtime import InferencePipeline as JPipeline
    from stif_tpu_torch.models import TMNet
    from torch_parity import load_into_port, random_params

    jm = JTMNet(**TM_CFG)
    params = random_params(jm, jnp.zeros((1, 2, 8, 8, 3)),
                           jnp.asarray([[0.5]]), seed=51)
    pm = load_into_port(TMNet(**TM_CFG), params)
    return (InferencePipeline(pm, bucket=4, device="cpu"),
            JPipeline(jm, params, bucket=4))


def test_render_window_tmnet(tmnet_pipes, rng):
    """4 frames of 6x10 (padded to 8x12 and cropped back) and 2 times:
    10 frames out at x4, within the model forward's 5e-5."""
    pipe, j_pipe = tmnet_pipes
    frames = rng.random((4, 6, 10, 3)).astype(np.float32)
    got = pipe.render_window_tmnet(frames, [0.25, 0.75])
    want = j_pipe.render_window_tmnet(frames, [0.25, 0.75])
    assert got.shape == want.shape == (10, 24, 40, 3)
    np.testing.assert_allclose(got, want, atol=5e-5)


@pytest.mark.parametrize("protocol", ["eval_adobe_tmnet", "eval_vid4_tmnet"])
def test_tmnet_protocol_matches_jax_pipeline(tmnet_pipes, tmp_path, protocol):
    """One synthetic folder through the JAX harness with the JAX pipeline
    and through the port's harness with the port's: PSNR within 1e-3 dB,
    SSIM within 1e-5. One window each: 19 frames of 64x96 (Adobe: LR 1/8,
    GT 1/2, 18 scored frames) or 7 frames of 32x48 (Vid4: 4 scored)."""
    pipe, j_pipe = tmnet_pipes
    adobe = protocol == "eval_adobe_tmnet"
    root = synthetic.render_eval_folders(
        str(tmp_path / "gt"), n_scenes=1, n_frames=19 if adobe else 7,
        size=(70, 100) if adobe else (32, 48), seed0=321)
    got = getattr(p_eval, protocol)(
        pipe, root, logfile=str(tmp_path / "port.log"), epoch_id=3, iter_id=4)
    want = getattr(j_eval, protocol)(j_pipe, root)
    assert list(got.psnr) == ["scene0"] and np.isfinite(got.mean_psnr)
    _assert_same(got, want)
    if adobe:
        assert got.mid_psnr > 0
    assert "[3/4]" in (tmp_path / "port.log").read_text()
