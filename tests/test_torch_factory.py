"""The port's model registry, factory, config parser, ``MLP`` and
provenance stamps against the JAX package's: the same names build the
corresponding classes, ``parse_options`` gives the same dictionaries, and
the ``MLP`` agrees within 5e-5 on converted parameters."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import stif_tpu.models as j_models
from stif_tpu.models import registry as j_registry
from stif_tpu.models.factory import define_g as j_define_g
from stif_tpu.utils import config as j_config
from stif_tpu.utils import provenance as j_provenance

import stif_tpu_torch.models as models
from stif_tpu_torch.models import registry
from stif_tpu_torch.models.ablations import LunaTokisAblation
from stif_tpu_torch.models.factory import define_g
from stif_tpu_torch.utils import config, provenance
from torch_parity import ROOT, load_into_port, random_params, t

TINY = dict(nf=8, nframes=6, groups=2, front_RBs=1, back_RBs=1)
WHICH = ["LIIF", "LIIF_train", "LIIF_noflow", "LIIF_S", "LunaTokis", "TMNet",
         "LIIF_test2", "LIIF_test3", "LIIF_test4", "LIIF_test5", "LIIF_nomul",
         "LIIF_single", "LIIF_continuous"]


def _opt(which, **net):
    return {"network_G": dict(which_model_G=which, **TINY, **net)}


def test_exports_and_registry_match():
    assert models.__all__ == j_models.__all__
    for name in models.__all__:
        assert hasattr(models, name), name
    assert sorted(registry._MODELS) == sorted(j_registry._MODELS)


@pytest.mark.parametrize("name", sorted(j_registry._MODELS))
def test_make_model_builds_every_registered_name(name):
    kw = dict(in_dim=5) if name == "mlp" else dict(TINY)
    model = models.make_model(name, **kw)
    assert isinstance(model, torch.nn.Module)
    assert sum(p.numel() for p in model.parameters()) > 0


def test_make_model_unknown_name_lists_inventory():
    with pytest.raises(KeyError) as ei:
        models.make_model("definitely_not_a_model")
    assert "LunaTokis" in str(ei.value) and "LIIF_test4" in str(ei.value)


@pytest.mark.parametrize("which", WHICH)
def test_define_g_returns_the_counterpart(which):
    """The port's class has the JAX class's name; an ablation carries its
    preset's wiring."""
    got, want = define_g(_opt(which)), j_define_g(_opt(which))
    assert type(got).__name__ == type(want).__name__
    if isinstance(got, LunaTokisAblation):
        for key in ("hr_ch", "stage_a", "stage_b", "stage_d", "encode_out",
                    "fold", "final_rgb"):
            assert getattr(got, key) == getattr(want, key), key
    n_blocks = len(got.feature_extraction if hasattr(got, "conv_first")
                   else got.encoder.feature_extraction)
    assert n_blocks == TINY["front_RBs"]


def test_define_g_unknown_raises():
    for which in ("nope", "LIIF_nope"):
        with pytest.raises(NotImplementedError):
            define_g(_opt(which))


def test_define_g_liif_knobs():
    """Every ``LIIF`` key of the JAX factory but ``lstm_fuse_dirs`` (a TPU
    arrangement of the same math, not read here); the dtype strings map to
    torch dtypes."""
    m = define_g(_opt("LIIF", gather_dtype="bf16", mlp_dtype="bfloat16",
                      rgb_skip="bicubic", stagec_dedup=True,
                      stagec_nearest=True, stagec_dtype="fp8",
                      lstm_fuse_dirs=True))
    assert m.gather_dtype is torch.bfloat16
    assert m.feat_imnet.compute_dtype is torch.bfloat16
    assert m.rgb_skip and m.rgb_skip_bicubic
    assert m.stagec_dedup and m.stagec_nearest
    assert m.stagec_dtype is torch.float8_e4m3fn
    m = define_g(_opt("LIIF", rgb_skip=True, stagec_dtype="bfloat16"))
    assert m.rgb_skip and not m.rgb_skip_bicubic
    assert m.stagec_dtype is torch.bfloat16 and m.gather_dtype is None
    # split-K takes the nets off the fused kernel, which has no such form
    m = define_g(_opt("LIIF", encode_splitk=True))
    assert m.encode_imnet.split_first and not m.encode_imnet.fused
    plain = define_g(_opt("LIIF"))
    assert plain.encode_imnet.fused and not plain.rgb_skip


@pytest.mark.parametrize("cfg", ["train_zsm.yml", "train_adobe_arbitrary.yml"])
@pytest.mark.parametrize("is_train", [True, False])
def test_parse_options(cfg, is_train):
    path = str(ROOT / "configs" / cfg)
    got = config.parse_options(path, is_train=is_train)
    want = j_config.parse_options(path, is_train=is_train)
    assert got == want
    assert isinstance(got, config.NoneDict)
    assert isinstance(got["network_G"], config.NoneDict)
    assert got["no_such_key"] is None and got["path"]["nope"] is None
    assert got["datasets"]["train"]["phase"] == "train"
    model = define_g(got)
    assert type(model).__name__ == type(j_define_g(want)).__name__


def test_parse_options_debug_and_check_resume(tmp_path):
    cfg = tmp_path / "debug.yml"
    cfg.write_text("name: debug_run\nscale: 4\n"
                   "datasets:\n  val_a:\n    mode: x\n"
                   "path:\n  resume_state: s\n")
    got = config.parse_options(str(cfg))
    want = j_config.parse_options(str(cfg))
    assert got == want
    assert got["train"]["val_freq"] == 8
    assert got["datasets"]["val_a"] == {"mode": "x", "phase": "val",
                                        "scale": 4}
    assert config.check_resume(got, 30) == j_config.check_resume(want, 30)
    assert got["path"]["pretrain_model_G"].endswith("params_30")
    assert config.dict_to_nonedict([{"a": 1}])[0]["b"] is None


def test_config_imports_without_yaml():
    """``yaml`` is needed only to parse a file."""
    import subprocess
    import sys

    code = ("import sys; sys.modules['yaml'] = None\n"
            "import stif_tpu_torch.utils.config as c\n"
            "assert c.NoneDict(a=1)['b'] is None\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_mlp(rng):
    jm = j_models.MLP(in_dim=5, out_dim=3, hidden_list=(16, 8))
    x = rng.standard_normal((2, 7, 5)).astype(np.float32)
    params = random_params(jm, jnp.asarray(x), seed=3)
    pm = load_into_port(models.MLP(5, 3, (16, 8)), params)
    assert list(pm.state_dict()) == [
        "layers.0.weight", "layers.0.bias", "layers.2.weight",
        "layers.2.bias", "layers.4.weight", "layers.4.bias"]
    want = np.asarray(jm.apply(params, x))
    with torch.inference_mode():
        got = pm(t(x)).numpy()
    assert got.shape == want.shape == (2, 7, 3)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_provenance_stamp(tmp_path):
    f = tmp_path / "w.pth"
    f.write_bytes(b"weights" * 1000)
    (tmp_path / "ckpt" / "sub").mkdir(parents=True)
    (tmp_path / "ckpt" / "sub" / "a").write_bytes(b"abc")
    for weights in (str(f), str(tmp_path / "ckpt")):
        got = provenance.stamp(weights=weights, step=7, config="c.yml")
        want = j_provenance.stamp(weights=weights, step=7, config="c.yml")
        assert got == want and got["weights_step"] == 7
    assert provenance.stamp() == {"git_commit": provenance.git_commit()}
    assert provenance.git_commit() == j_provenance.git_commit()
