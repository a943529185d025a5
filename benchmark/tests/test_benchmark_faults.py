"""A run driven end to end on the CPU at a small size, past the harness's
look for a card: sound, every cell comes out correct; with the timed path
broken underneath, once for each fault a cell can have, it comes out not
correct. The cells run one chip, so there is no exchange between chips to
leave out."""

from __future__ import annotations

import json

import pytest

from benchmark import run

TINY = {"nf": 8, "groups": 2, "front_RBs": 1, "back_RBs": 1}
DRAW = {"draw": {"offset_px": 2.0}}
SMALL = {
    "stif-x4t8-720p": {"config": {"weights": DRAW},
                       "traffic": {"hr_size": [64, 96], "pool": 3}},
    "stif-x16t5-720p": {"config": {"weights": DRAW},
                        "traffic": {"hr_size": [128, 192], "pool": 3}},
    "tmnet-x4t5-adobe": {"config": {},
                         "traffic": {"hr_size": [64, 96], "pool": 2}},
    "stif-train-r5": {"config": {"weights": DRAW, "train_batch_size": 2},
                      "traffic": {"scale_plan": [
                          [2, 8], [3, 8], [4, 8], [2, 8]]}},
}


def drive(cell: str, capsys, trace: int = 0) -> dict:
    man = run.harness.manifest()
    w = run.harness.workload(man, cell)
    base = run.harness.load_json(run.harness.BENCH / "configs"
                                 / f"{w['config']}.json")
    over = {k: dict(v) for k, v in SMALL[cell].items()}
    over["config"]["network_G"] = {**base["network_G"], **TINY}
    rc = run.main(["--workload", cell, "--seed", str(2 ** 32 + 3),
                   "--seconds", "0.5", "--trace", str(trace)], device="cpu",
                  overrides=over)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", list(SMALL))
def test_sound_run_is_correct(cell, capsys):
    line = drive(cell, capsys)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0


@pytest.mark.parametrize("cell", ["stif-x4t8-720p", "tmnet-x4t5-adobe",
                                  "stif-train-r5"])
def test_traced_run_reads_a_slice_and_no_device_metric(cell, capsys):
    line = drive(cell, capsys, trace=1)
    assert line["correct"] and line["metrics"] == {}
    assert line["device"]["window_s"] > 0
    assert line["breakdown"]["idle_gaps"]


def _altered(fn):
    def wrapper(*args, **kwargs):
        frames = fn(*args, **kwargs).copy()
        frames[0, 0, 0, 0] += 0.25
        return frames
    return wrapper


def test_answer_altered_stream(capsys, monkeypatch):
    from stif_tpu_torch.runtime.pipeline import InferencePipeline

    monkeypatch.setattr(InferencePipeline, "_fetch",
                        _altered(InferencePipeline._fetch))
    assert not drive("stif-x4t8-720p", capsys)["correct"]


def test_answer_altered_tmnet(capsys, monkeypatch):
    from stif_tpu_torch.runtime.pipeline import InferencePipeline

    monkeypatch.setattr(InferencePipeline, "render_window_tmnet",
                        _altered(InferencePipeline.render_window_tmnet))
    assert not drive("tmnet-x4t5-adobe", capsys)["correct"]


def test_step_returns_state_unchanged(capsys, monkeypatch):
    from stif_tpu_torch.train import trainer

    monkeypatch.setattr(trainer.Optimizer, "update",
                        lambda self: trainer.global_norm(self.grads))
    line = drive("stif-train-r5", capsys)
    assert not line["correct"]
    assert line["checks"]["update_gap"]["value"] >= 0.99


def test_step_returns_ema_unchanged(capsys, monkeypatch):
    from stif_tpu_torch.train import trainer

    monkeypatch.setattr(trainer.EMA, "update", lambda self: None)
    line = drive("stif-train-r5", capsys)
    assert not line["correct"]
    assert line["checks"]["ema_gap"]["value"] >= 0.99


def test_half_batch_left_out(capsys, monkeypatch):
    from stif_tpu_torch.train import trainer

    whole = trainer.make_loss_fn

    def half(model, cfg):
        fn = whole(model, cfg)

        def loss(batch):
            n = batch["lqs"].shape[0] // 2
            return 2.0 * fn({k: v[:n] for k, v in batch.items()})
        return loss

    monkeypatch.setattr(trainer, "make_loss_fn", half)
    assert not drive("stif-train-r5", capsys)["correct"]
