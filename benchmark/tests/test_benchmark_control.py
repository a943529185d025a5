"""The control comes out as not correct: the reference in TF32 (the
precision below the fp32 with TF32 off that every configuration states),
and for the train cell the half-batch fault, read by each cell's own
comparison against its limits, at the cells' widths and a size a test run
holds. Needs the card (TF32 exists only there)."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import control, harness, run

SMALL = {
    "stif-x4t8-720p": {"hr_size": [192, 320], "pool": 1},
    "stif-x16t5-720p": {"hr_size": [352, 640], "pool": 1},
    "tmnet-x4t5-adobe": {"hr_size": [352, 640], "pool": 1},
    "stif-train-r5": {"scale_plan": [[2, 32], [4, 32], [8, 16]]},
}
# the configurations' own files, but for the train batch
CONFIG = {"stif-train-r5": {"train_batch_size": 2}}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(SMALL))
def test_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("TF32 and the control run on the card")
    man = harness.manifest()
    w, config, traffic, spec = run.cell_files(
        man, cell, {"traffic": SMALL[cell], "config": CONFIG.get(cell, {})})
    spec = {**spec, "check": {**spec["check"], "sample": 1}}
    entry = harness.load_module(harness.BENCH / "entries"
                                / f"{spec['entry']}.py")
    r = harness.Run(name=cell, config=config, traffic=traffic, cell=spec,
                    seed=2 ** 31 + 9, seconds=0.0, trace=False,
                    device=torch.device("cuda", 0), root=harness.ROOT,
                    started=time.perf_counter())
    read = (control.training if spec["entry"] == "train_step"
            else control.serving)
    limits = spec["check"]["limits"]
    for rec in read(r, entry):
        checks = [(k, rec[k], lim) for k, lim in limits.items()]
        assert not harness.correct(checks), rec
