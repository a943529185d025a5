"""The port's accounting (``stif_tpu_torch/utils/trace.py``) on the CPU:
stage marks and host spans, their tables, and what ``Program.stats()``
reports of them.

The CPU has no CUDA graphs: compiled pipelines and train steps get the
capture step's test double (``torch_parity.replay_double``), which runs
the callable again at each replay, so a replay's marks measure the host's
``perf_counter_ns`` into the program's table as a graph's mark kernels do
on the card. Small models: LunaTokis nf 8, groups 2, 1 + 1 blocks,
``rgb_skip`` bicubic; TMNet nf 8; LR 8x8.
"""

import numpy as np
import pytest
import torch

from stif_tpu_torch.models import LunaTokis
from stif_tpu_torch.models.tmnet import TMNet
from stif_tpu_torch.runtime import InferencePipeline, ProgramCache
from stif_tpu_torch.train.video_sr_model import VideoSRModel
from stif_tpu_torch.utils import misc, trace
from torch_parity import replay_double

TIMES = [0.0, 0.5]
ENCODE = ["encode.front", "encode.pcd", "encode.convlstm", "encode.trunk"]
DECODE = ["decode.prep", "decode.ab", "decode.cd"]
PHASES = ["train.forward", "train.backward", "train.update", "train.ema"]


def double_cache():
    return ProgramCache("cpu", capture=replay_double)


@pytest.fixture(scope="module")
def luna():
    torch.manual_seed(0)
    return LunaTokis(nf=8, groups=2, front_RBs=1, back_RBs=1, rgb_skip=True,
                     rgb_skip_bicubic=True).eval()


@pytest.fixture(scope="module")
def tmnet():
    torch.manual_seed(1)
    return TMNet(nf=8, groups=2, front_RBs=1, back_RBs=1).eval()


def _frames(n=2, h=8, w=8, seed=0):
    return np.random.default_rng(seed).random((n, h, w, 3)).astype(
        np.float32)


def _opened(monkeypatch):
    """The (open | close, stage) sequence of every mark made, in order."""
    seen = []
    real_open, real_close = trace.Marks.open, trace.Marks.close

    def opened(self, slot):
        seen.append(("open", trace.STAGES[slot]))
        real_open(self, slot)

    def closed(self, slot):
        seen.append(("close", trace.STAGES[slot]))
        real_close(self, slot)

    monkeypatch.setattr(trace.Marks, "open", opened)
    monkeypatch.setattr(trace.Marks, "close", closed)
    return seen


def _nest(seq):
    """The stages of ``seq`` as a tree: [(stage, children), ...]; asserts
    that every mark closes the innermost one open."""
    root, stack = [], []
    for what, stage in seq:
        if what == "open":
            node = (stage, [])
            (stack[-1][1] if stack else root).append(node)
            stack.append(node)
        else:
            assert stack and stack[-1][0] == stage, (stage, stack)
            stack.pop()
    assert not stack
    return root


def test_stage_order_and_nesting(monkeypatch, luna, tmnet):
    """One eager window of each model: the marks nest, each child inside
    its parent (a name's prefix), in the order the forward runs them."""
    seen = _opened(monkeypatch)
    x = torch.from_numpy(_frames()[None])
    with torch.inference_mode():
        luna(x, torch.tensor(TIMES))
    tree = _nest(seen)
    assert [(s, [c for c, _ in kids]) for s, kids in tree] == [
        ("encode", ENCODE), ("decode", DECODE)]
    seen.clear()
    with torch.inference_mode():
        tmnet(torch.from_numpy(_frames(3)[None]),
              torch.tensor([[0.25, 0.5]]))
    tree = _nest(seen)
    # two pairs, two times each: four time-modulated alignments
    assert [(s, [c for c, _ in kids]) for s, kids in tree] == [
        ("encode", ["encode.front"] + ["encode.pcd"] * 4
         + ["encode.convlstm", "encode.trunk"]), ("head", [])]
    for stage in trace.STAGES:  # a parent comes before its children
        parent = stage.rsplit(".", 1)[0]
        assert trace.SLOT.get(parent, -1) <= trace.SLOT[stage]


def test_parents_hold_their_children(luna, tmnet):
    """In a program's table every parent's time is at least its children's
    sum, and a window opens each stage once (``encode.pcd`` once per pair
    and time)."""
    pipe = InferencePipeline(luna, device="cpu", compiled=double_cache(),
                             bucket=4)
    for _ in range(3):
        pipe.render_window(_frames(), TIMES)
    tm = InferencePipeline(tmnet, device="cpu", compiled=double_cache(),
                           bucket=4)
    for _ in range(2):
        tm.render_window_tmnet(_frames(3), [0.25, 0.5])
    for pipe, per_window in ((pipe, {}), (tm, {"encode.pcd": 4})):
        (st,) = pipe.programs.stats()
        stages = st["stages"]
        for stage, row in stages.items():
            assert row["n"] == per_window.get(stage, 1) * st["replays"]
            kids = [k for k in stages if k.rsplit(".", 1)[0] == stage
                    and k != stage]
            assert row["device_ms"] >= sum(stages[k]["device_ms"]
                                           for k in kids) > 0 or not kids
        assert set(stages) == set(
            ["encode", "decode"] + ENCODE + DECODE if pipe is not tm
            else ["encode", "head"] + ENCODE)


def test_tables_count_replays_only(luna):
    """The first call's warm-up and capture add nothing to the program's
    tables, nor to the eager ones: its stages count its replays (the first
    call's own replay too), its host spans the calls that found it made."""
    pipe = InferencePipeline(luna, device="cpu", compiled=double_cache(),
                             bucket=4)
    eager = trace.eager_stats("cpu")
    pipe.render_window(_frames(), TIMES)
    (program,) = pipe.programs.programs.values()
    st = program.stats()
    assert st["replays"] == 1 and st["host"] == {}
    assert {row["n"] for row in st["stages"].values()} == {1}
    assert trace.eager_stats("cpu") == eager
    for k in (2, 3):
        pipe.render_window(_frames(), TIMES)
        st = program.stats()
        assert st["replays"] == k
        assert {row["n"] for row in st["stages"].values()} == {k}
        assert {name: row["n"] for name, row in st["host"].items()} == {
            "stage.pad": k - 1, "stage.upload": k - 1,
            "launch.copy_in": k - 1, "launch.replay": k - 1}
        assert all(row["ms"] > 0 for row in st["host"].values())
    assert trace.eager_stats("cpu") == eager


def test_span_lands_on_the_program_its_window_replays(luna):
    """Windows of two buckets streamed in turns: each window's staging,
    launch and fetch go to the program it replays; an eager pipeline's to
    the eager table."""
    pipe = InferencePipeline(luna, device="cpu", compiled=double_cache(),
                             bucket=4)
    small, wide = _frames(), _frames(w=16)
    order = [small, wide, small, small, wide, small]
    list(pipe.stream(pipe.stage(f, TIMES) for f in order))
    by_key = {st["key"].split("]")[0]: st for st in pipe.programs.stats()}
    assert len(by_key) == 2
    for st in by_key.values():
        windows = 4 if "8, 8, 3" in st["key"] else 2
        assert st["replays"] == windows
        assert {row["n"] for row in st["host"].values()} == {windows - 1}
    eager = InferencePipeline(luna, device="cpu", compiled=False, bucket=4)
    before = trace.eager_stats("cpu")["host"]
    list(eager.stream(eager.stage(f, TIMES) for f in order[:3]))
    after = trace.eager_stats("cpu")["host"]
    for name in ("stage.pad", "stage.upload"):
        assert after[name]["n"] == before.get(name, {"n": 0})["n"] + 3
    assert "launch.replay" not in after or after["launch.replay"] == \
        before["launch.replay"]


def test_tally_numbers_each_window_and_commits_once():
    a, b = trace.Tally(), trace.Tally()
    assert b.seq > a.seq
    into = trace.Spans()
    with trace.span("stage.pad", into=a):
        pass
    a.bind(into)
    a.commit()
    a.commit()
    assert into.read()["stage.pad"]["n"] == 1
    with trace.span("fetch.copy", into=b):
        pass
    b.commit()  # bound to nothing: dropped
    assert "fetch.copy" not in into.read()


def test_grad_enabled_opens_no_model_stage(monkeypatch, tmp_path):
    """A train step (eager, and replayed through the double): the four
    phases open with grad on, no model stage does (the forward and the
    rematerialised passes in the backward run with grad on)."""
    seen = _opened(monkeypatch)
    opt = {"model": "VideoSR_base",
           "network_G": dict(which_model_G="LIIF", nf=8, nframes=6, groups=2,
                             front_RBs=1, back_RBs=1, rgb_skip="bicubic"),
           "train": dict(lr_G=1e-3, warmup_iter=-1, T_period=[100],
                         restarts=[], restart_weights=[], eta_min=1e-7,
                         grad_clip=1e6, ema_decay=0.9)}
    rng = np.random.default_rng(0)
    batch = {"LQs": rng.random((2, 2, 8, 8, 3)).astype(np.float32),
             "GT": rng.random((2, 2, 32, 32, 3)).astype(np.float32),
             "times": np.asarray([0.0, 0.5], np.float32)}
    cache = double_cache()
    for compiled in (False, cache):
        m = VideoSRModel(opt, device="cpu", compiled=compiled)
        m.init_params(batch["LQs"], batch["times"])
        for _ in range(3):
            m.feed_data(batch)
            m.optimize_parameters()
        assert {s for _, s in seen} == set(PHASES)
        seen.clear()
    (st,) = cache.stats()
    assert {k: v["n"] for k, v in st["stages"].items()} == {
        k: st["replays"] for k in PHASES}
    host = {k: v["n"] for k, v in st["host"].items()}
    assert host == {"train.feed": 2, "launch.copy_in": 2,
                    "launch.replay": 2, "train.logs": 2}


def test_every_program_line_holds_the_accounting(luna):
    """A program's line keeps every key it had and adds ``stages``,
    ``host`` and ``graph_nodes``, always, from its first call on: no node
    count on the CPU, no host span of that call, and its one replay in
    every stage."""
    cache = double_cache()
    pipe = InferencePipeline(luna, device="cpu", compiled=cache, bucket=4)
    pipe.render_window(_frames(), TIMES)
    (st,) = cache.stats()
    assert set(st) == {"key", "replays", "warmup_ms", "capture_ms",
                       "pool_bytes", "held_constants", "launches",
                       "graph_nodes", "stages", "host"}
    assert st["graph_nodes"] is None and st["host"] == {}
    assert {row["n"] for row in st["stages"].values()} == {st["replays"]}


def test_trace_span_is_the_spans_primitive():
    """``misc.trace_span`` is ``trace.span``; a span with no tally goes to
    the eager table."""
    assert misc.trace_span is trace.span
    before = trace.eager_stats("cpu")["host"].get("x.span", {"n": 0})["n"]
    with misc.trace_span("x.span"):
        pass
    assert trace.eager_stats("cpu")["host"]["x.span"]["n"] == before + 1
