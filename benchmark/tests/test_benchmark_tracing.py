"""The readers of the port's own accounting (``marks.py``:
``encoder_ms``, ``decoder_ms``, ``host_ms``, ``backward_ms``) on hand-made
outcomes, and on a program that keeps no such table; then one serving
entry on the CPU, whose programs' lines they read."""

from __future__ import annotations

import pytest

from benchmark import harness

READERS = ("encoder_ms.serve", "decoder_ms.serve", "host_ms.serve",
           "host_ms.train", "backward_ms.train")


def reader(metric: str):
    return harness.load_module(harness.reader_path(metric))


def outcome(programs) -> harness.Outcome:
    return harness.Outcome(attempted=1, failed=0, e2e={}, setup_end=0.0,
                           window={"seconds": 1.0, "shapes": []},
                           memory_peak_bytes=0, checks=[],
                           notes={"programs": programs})


def program(stages=None, host=None, replays=4) -> dict:
    line = {"key": "window", "replays": replays, "launches": {},
            "graph_nodes": 3000}
    if stages is not None:
        line["stages"] = {k: {"n": n, "device_ms": ms}
                          for k, (n, ms) in stages.items()}
    if host is not None:
        line["host"] = {k: {"n": n, "ms": ms} for k, (n, ms) in host.items()}
    return line


SERVE = {"stage.pad": (3, 3.0), "stage.upload": (3, 1.5),
         "launch.copy_in": (3, 0.3), "launch.replay": (3, 20.0),
         "fetch.wait": (3, 600.0), "fetch.copy": (3, 12.0)}


@pytest.mark.parametrize("metric", READERS)
def test_a_reader_exists_for_each_new_metric(metric):
    assert harness.reader_path(metric).is_file()
    names = [m["name"] for m in harness.manifest()["per_layer"]]
    assert metric in names


def test_stage_readers_divide_by_the_summed_counts():
    """Two programs (two buckets): the sums over both, over their summed
    counts."""
    got = outcome([
        program({"encode": (4, 400.0), "decode": (4, 800.0),
                 "train.backward": (2, 50.0)}),
        program({"encode": (2, 260.0), "decode": (2, 340.0),
                 "train.backward": (1, 40.0)}, replays=2)])
    assert reader("encoder_ms.serve").read(got, "x") == pytest.approx(110.0)
    assert reader("decoder_ms.serve").read(got, "x") == pytest.approx(190.0)
    assert reader("backward_ms.train").read(got, "x") == pytest.approx(30.0)


def test_host_reader_leaves_out_the_waits_and_the_launch():
    """``host_ms``: padding, upload, static-input copy and the frames'
    copy per steady window, not ``fetch.wait`` or ``launch.replay``; the
    train step's feed, copy and logs likewise."""
    serve = outcome([program(host=SERVE)])
    assert reader("host_ms.serve").read(serve, "x") == pytest.approx(
        (3.0 + 1.5 + 0.3 + 12.0) / 3)
    train = outcome([program(host={
        "train.feed": (9, 18.0), "launch.copy_in": (9, 0.9),
        "launch.replay": (9, 360.0), "fetch.wait": (9, 3000.0),
        "train.logs": (9, 0.09)})])
    assert reader("host_ms.train").read(train, "x") == pytest.approx(
        (18.0 + 0.9 + 0.09) / 9)


@pytest.mark.parametrize("metric", READERS)
def test_a_program_without_the_tables_reads_none(metric):
    """A port that keeps no stage or span table (its lines lack the keys),
    a run with no programs, and one whose notes are empty: None, no
    raise."""
    for got in (outcome([program()]), outcome([]), outcome(None)):
        assert reader(metric).read(got, "x") is None
    bare = outcome([program()])
    bare.notes = None
    assert reader(metric).read(bare, "x") is None


def test_the_serving_entry_reports_the_tables_on_the_cpu():
    """The STIF serving entry at a tiny size on the CPU, compiled through
    the capture double: its programs' lines carry ``stages`` and ``host``,
    and the readers turn them into numbers."""
    import sys
    from pathlib import Path

    import numpy as np
    from stif_tpu_torch.runtime import ProgramCache
    from stif_tpu_torch.runtime import pipeline

    sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "tests"))
    from torch_parity import replay_double

    from stif_tpu_torch.models import LunaTokis

    model = LunaTokis(nf=8, groups=2, front_RBs=1, back_RBs=1).eval()
    pipe = pipeline.InferencePipeline(
        model, device="cpu", bucket=4,
        compiled=ProgramCache("cpu", capture=replay_double))
    frames = np.random.default_rng(0).random((2, 8, 8, 3)).astype(
        np.float32)
    list(pipe.stream(pipe.stage(frames, [0.0, 0.5]) for _ in range(4)))
    got = outcome(pipe.programs.stats())
    enc = reader("encoder_ms.serve").read(got, "cpu")
    dec = reader("decoder_ms.serve").read(got, "cpu")
    host = reader("host_ms.serve").read(got, "cpu")
    assert enc > 0 and dec > 0 and host > 0
