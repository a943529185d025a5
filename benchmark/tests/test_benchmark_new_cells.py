"""The cells ``liif-train-x4t8-720p`` and ``stif-x4t8-1080p-chunked``
driven end to end on the CPU at a small size, past the harness's look for
a card: sound, each comes out correct; with the answer altered, not. Also
``LIIF_train``'s weights and its metrics' readers."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import harness, run
from benchmark.roofline import liif_train
from benchmark.tests.test_benchmark_faults import TINY, _altered

SMALL = {"traffic": {"hr_size": [64, 96], "pool": 3}}


@pytest.fixture(scope="module")
def encoder_file(tmp_path_factory):
    """A flagship ``.pth`` at the tiny widths: the encoder's file of a
    small ``liif-train``."""
    from stif_tpu_torch.models.factory import define_g

    torch.manual_seed(3)
    net = define_g({"network_G": {"which_model_G": "LIIF", **TINY}})
    for k, v in net.state_dict().items():  # offsets that deform
        if "conv_offset_mask" in k:
            v.uniform_(-0.5, 0.5)
    path = tmp_path_factory.mktemp("w") / "tiny_G.pth"
    torch.save({"module." + k: v for k, v in net.state_dict().items()}, path)
    return path


def overrides(cell: str, encoder_file) -> dict:
    w = harness.workload(harness.manifest(), cell)
    base = harness.load_json(harness.BENCH / "configs" / f"{w['config']}.json")
    weights = ({**base["weights"], "encoder_file": str(encoder_file)}
               if cell.startswith("liif") else {"draw": {"offset_px": 2.0}})
    over = {"config": {"network_G": {**base["network_G"], **TINY},
                       "weights": weights}, **SMALL}
    if "chunked" in cell:
        over["cell"] = {"chunk": 1000}
    return over


def drive(cell: str, encoder_file, capsys, trace: int = 0) -> dict:
    rc = run.main(["--workload", cell, "--seed", str(2 ** 31 + 11),
                   "--seconds", "0.5", "--trace", str(trace)], device="cpu",
                  overrides=overrides(cell, encoder_file))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


CELLS = ["liif-train-x4t8-720p", "stif-x4t8-1080p-chunked"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, encoder_file, capsys):
    line = drive(cell, encoder_file, capsys)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"frames_per_s", "window_p90_ms",
                                    "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_a_slice_and_no_device_metric(cell, encoder_file,
                                                       capsys):
    line = drive(cell, encoder_file, capsys, trace=1)
    assert line["correct"] and line["metrics"] == {}
    assert line["device"]["window_s"] > 0


@pytest.mark.parametrize("cell,method", [
    ("liif-train-x4t8-720p", "_fetch"),
    ("stif-x4t8-1080p-chunked", "render_pairs")])
def test_answer_altered(cell, method, encoder_file, capsys, monkeypatch):
    from stif_tpu_torch.runtime.pipeline import InferencePipeline

    monkeypatch.setattr(InferencePipeline, method,
                        _altered(getattr(InferencePipeline, method)))
    assert not drive(cell, encoder_file, capsys)["correct"]


def _run(encoder_file, seed) -> harness.Run:
    cell = "liif-train-x4t8-720p"
    over = overrides(cell, encoder_file)
    w, config, traffic, spec = run.cell_files(harness.manifest(), cell, over)
    return harness.Run(name=cell, config=config, traffic=traffic, cell=spec,
                       seed=seed, seconds=0.0, trace=False, device="cpu",
                       root=harness.ROOT, started=0.0)


def test_liif_train_weights(encoder_file):
    """Every ``encoder.`` key is the file's under the flagship's name; the
    nets are ``weights.draw``'s under the seed, not the program's init,
    but for the flow head's output biases, drawn in +-``flow_px``; another
    seed draws others."""
    from benchmark import weights
    from benchmark.entries import serve_liif_train as entry

    r = _run(encoder_file, 5)
    net, state = entry.weights_of(r)
    trained = torch.load(encoder_file, weights_only=True)
    enc = [k for k in state if k.startswith("encoder.")]
    assert enc and all(torch.equal(state[k], trained["module." + k[8:]])
                       for k in enc)
    assert set(state) == set(net.state_dict())
    nets = {k: v.shape for k, v in net.state_dict().items()
            if not k.startswith("encoder.")}
    drawn = weights.draw(nets, r.config["weights"]["draw"], 5, "cpu")
    head = "flow_imnet.net.4.bias"
    assert len(nets) == 32 and all(torch.equal(state[k], drawn[k])
                                   for k in nets if k != head)
    px = r.config["weights"]["flow_px"]
    assert px == 3.0 and state[head].shape == (4,)
    assert 0 < state[head].abs().max() <= px and not drawn[head].any()
    _, other = entry.weights_of(_run(encoder_file, 6))
    for k in ("feat_imnet.net.0.linear.weight", head):
        assert not torch.equal(other[k], state[k])


def test_liif_train_weights_need_every_encoder_key(encoder_file, tmp_path):
    from benchmark.entries import serve_liif_train as entry

    trained = torch.load(encoder_file, weights_only=True)
    del trained["module.recon_trunk.0.conv1.weight"]
    torch.save(trained, tmp_path / "short.pth")
    r = _run(encoder_file, 5)
    r.config["weights"] = {**r.config["weights"],
                           "encoder_file": str(tmp_path / "short.pth")}
    with pytest.raises(KeyError, match="recon_trunk.0.conv1.weight"):
        entry.weights_of(r)


def test_readers_read_only_liif_train_units():
    """``mfu_liif_train`` counts ``liif_train`` units only, and the SIREN
    reader finds nothing in a slice without the kernel or such units."""
    mfu = harness.load_module(harness.reader_path("mfu_liif_train.serve"))
    roof = harness.load_module(harness.reader_path(
        "siren_liif_train_roofline.serve"))
    arch = {"nf": 64, "groups": 8, "front_RBs": 5, "back_RBs": 40}
    u = {"model": "liif_train", "arch": arch, "batch": 1, "lr": [180, 320],
         "nt": 8, "out": [720, 1280]}
    stif = dict(u, model="stif")
    card = "NVIDIA H100 80GB HBM3"
    out = harness.Outcome(attempted=1, failed=0, e2e={}, setup_end=0.0,
                          window={"seconds": 0.3, "shapes": [[u, 1]]},
                          memory_peak_bytes=0, checks=[],
                          slice={"kernels": {"siren_fused_kernel_x": 0.05},
                                 "shapes": [u]})
    # 388,352 FLOP a query and time of the nets (feat_imnet's once a
    # query), 7.37 M of them, and the encoder's
    flops = liif_train.flops(u)
    assert flops > 388352 * 7372800 == liif_train.work_of(u)["flops"]
    assert mfu.read(out, card) == pytest.approx(100 * flops / 0.3 / 495e12)
    assert 0 < roof.read(out, card) < 100
    out.window["shapes"] = [[stif, 1]]
    out.slice["shapes"] = [stif]
    assert mfu.read(out, card) is None and roof.read(out, card) is None
