"""The work functions held to what the reference does: FLOPs against
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference, the
DCN call list against the reference's calls, bytes against the operands'
sizes, and the peaks table."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import weights
from benchmark.reference import ops, stif, tmnet
from benchmark.roofline import dcn, model, peaks, siren

ARCH = {"nf": 8, "groups": 2, "front_RBs": 1, "back_RBs": 2}


def state_of(which: str, **extra):
    from stif_tpu_torch.models.factory import define_g

    net = define_g({"network_G": {"which_model_G": which, **ARCH, **extra}})
    return weights.draw({k: v.shape for k, v in net.state_dict().items()},
                        {"offset_px": 2.0}, 5, "cpu")


def by_shape(calls) -> dict:
    """The calls' batch summed per shape: the reference runs the ConvLSTM's
    two directions one after the other, the program at twice the batch."""
    out = {}
    for c in calls:
        out[c[1:]] = out.get(c[1:], 0) + c[0]
    return out


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        fn()
    return fc.get_total_flops()


class Calls:
    """The reference's DCN calls as (x, offset-mask, weight, bias, out)."""

    def __init__(self, monkeypatch):
        self.seen = []
        plain = ops.deform_conv

        def spy(P, name, x, fea, groups, *a, **k):
            out = plain(P, name, x, fea, groups, *a, **k)
            w = P[f"{name}.weight"]
            self.seen.append((x.shape[0], x.shape[1], x.shape[2], x.shape[3],
                              out.shape[1], out.shape[2], w.shape[0],
                              w.shape[2] * w.shape[3], groups))
            return out

        for mod in (stif, tmnet):
            monkeypatch.setattr(mod, "deform_conv", spy)


@pytest.mark.parametrize("B,lr,nt,out", [(1, (12, 20), 3, (48, 80)),
                                         (2, (9, 13), 2, (27, 39))])
def test_stif_flops_and_dcn_calls(B, lr, nt, out, monkeypatch):
    P = state_of("LIIF", rgb_skip="bicubic")
    x = torch.rand(B, 2, *lr, 3)
    t = torch.linspace(0, 1, nt)
    calls = Calls(monkeypatch)
    got = counted(lambda: stif.forward(P, ARCH, x, t, out, block=700))
    count = model.stif(ARCH, B, lr, nt, out)
    assert got == count.flops
    assert by_shape(calls.seen) == by_shape(count.dcn_calls)


def test_train_step_work_is_three_forwards():
    from benchmark.entries import train_step

    r = type("R", (), {"arch": ARCH, "traffic": {"nt": 2},
                       "config": {"train_batch_size": 3}})()
    unit = train_step.step_unit(r, 4, 12)
    count = model.stif(ARCH, 3, (12, 12), 2, (48, 48))
    assert model.flops(unit) == 3 * count.flops
    assert dcn.backward_of(unit) == dcn.backward(count.dcn_calls)
    assert dcn.forward_of(unit) == dcn.forward(count.dcn_calls)
    assert siren.work_of(unit) == siren.work(8, 3, 2, 48 * 48)


@pytest.mark.parametrize("unit", [
    {"model": "stif", "arch": ARCH, "batch": 1, "lr": [12, 20], "nt": 3,
     "out": [48, 80]},
    {"model": "tmnet", "arch": ARCH, "batch": 1, "frames": 4,
     "lr": [12, 20], "t_n": 3}], ids=["stif", "tmnet"])
def test_a_serving_unit_reads_its_forward(unit):
    count = (model.stif(ARCH, 1, (12, 20), 3, (48, 80))
             if unit["model"] == "stif"
             else model.tmnet(ARCH, 1, 4, (12, 20), 3))
    assert model.flops(unit) == count.flops
    assert dcn.forward_of(unit) == dcn.forward(count.dcn_calls)
    assert dcn.backward_of(unit) == {"flops": 0, "bytes": 0}
    want = (siren.work(8, 1, 3, 48 * 80) if unit["model"] == "stif"
            else {"flops": 0, "bytes": 0})
    assert siren.work_of(unit) == want


def test_tmnet_flops_and_dcn_calls(monkeypatch):
    P = state_of("TMNet")
    x = torch.rand(1, 4, 12, 20, 3)
    t = torch.tensor([[0.2, 0.5, 0.7]])
    calls = Calls(monkeypatch)
    got = counted(lambda: tmnet.forward(P, ARCH, x, t))
    count = model.tmnet(ARCH, 1, 4, (12, 20), 3)
    assert got == count.flops
    assert by_shape(calls.seen) == by_shape(count.dcn_calls)


def test_siren_flops_match_the_counter():
    P = state_of("LIIF", rgb_skip="bicubic")
    rows = 37
    fields = {"feat_imnet": 3 * 8 + 9, "flow_imnet": 3 * 8 + 71,
              "encode_imnet": 6 * 8 + 141}
    got = sum(counted(lambda n=n, c=c: ops.siren(P, n, [torch.rand(rows, c)]))
              for n, c in fields.items())
    assert got == siren.work(8, 1, 1, rows)["flops"]


def test_siren_bytes_against_the_operands():
    """One pair, one time: each net's fields, weights and outputs, the
    time counted once per time and pair."""
    P = state_of("LIIF", rgb_skip="bicubic")
    Q, nf = 50, 8
    seen = []
    for name, width in (("feat_imnet", 3 * nf + 8),
                        ("flow_imnet", 64 + 3 * nf + 6),
                        ("encode_imnet", 2 * 64 + 6 * nf + 12)):
        x = torch.rand(1, Q, width)
        out = ops.siren(P, name, [x, torch.rand(1, Q, 1)])
        params = sum(v.numel() for k, v in P.items() if k.startswith(name))
        seen.append(x.numel() + 1 + out.numel() + params)
    # the flow net's 64-wide HR feature is the feature net's output: the
    # work counts it read once per time, as here
    assert siren.work(nf, 1, 1, Q)["bytes"] == 4 * sum(seen)


def test_dcn_bytes_against_the_operands():
    P = state_of("LIIF", rgb_skip="bicubic")
    name = "pcd_align.L1_dcnpack_1"
    x, fea = torch.rand(2, 6, 7, 8), torch.rand(2, 6, 7, 8)
    out = ops.deform_conv(P, name, x, fea, 2)
    w = P[f"{name}.weight"]
    om = 2 * 6 * 7 * 2 * 9 * 3  # offsets (2 per tap and group) and mask
    call = (2, 6, 7, 8, 6, 7, 8, 9, 2)
    want = x.numel() + om + w.numel() + 8 + out.numel()
    assert dcn.forward([call])["bytes"] == 4 * want
    assert dcn.forward([call])["flops"] == 2 * 2 * 42 * 9 * 8 * 8
    grads = x.numel() + om + w.numel()
    assert dcn.backward([call])["bytes"] == 4 * (out.numel() + x.numel() + om
                                                 + w.numel() + grads)


def test_peaks_table():
    assert peaks.peak("NVIDIA H100 80GB HBM3") == {"flops": 495e12,
                                                   "bytes": 3.35e12}
    assert peaks.bound_s(495e12, 1.0, "NVIDIA H100 80GB HBM3") == 1.0
    with pytest.raises(KeyError):
        peaks.peak("NVIDIA A100-SXM4-80GB")
