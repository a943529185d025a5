#!/usr/bin/env python
"""Merge per-decode-mode eval records into one EVAL artifact (the port's
own copy of ``tools/aggregate_eval.py``).

Reads the JSON records ``scripts/eval_model_torch.py --out`` writes, one per
decode mode: plain, bf16, local ensemble, local ensemble with the x8
self-ensemble, and optionally the stage-C knobs. Writes the plain record in
full (scale sweep, x16, wide families) plus a per-mode summary table, the
bf16 gate's deltas, the stage-C knobs' deltas, and a block naming which
modes clear the quality bars: t = 0 Y-PSNR at least the bicubic baseline,
t = 0.5 at least 29.5 dB.

    python scripts/aggregate_eval_torch.py --plain EVAL_plain.json \
        [--bf16 EVAL_bf16.json] [--le EVAL_le.json] [--le-se EVAL_le_se.json] \
        [--stagec-dedup ...] [--stagec-nearest ...] [--stagec-fp8 ...] \
        --out EVAL.json

A missing or unreadable optional record is skipped with a warning; a
missing plain record is an error.
"""

import argparse
import json
import sys

T05_BAR = 29.5  # dB, Y-PSNR at t = 0.5


def _load(path):
    if not path:
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except OSError:
        return None
    except json.JSONDecodeError as e:
        # a truncated optional record (an interrupted run) is skipped like a
        # missing one
        print(f"[aggregate_eval] WARNING: skipping unparseable {path}: {e}",
              file=sys.stderr)
        return None


def _times(rec):
    bt = rec["psnr_y_by_time"]
    st = rec.get("ssim_y_by_time", {})
    return {
        "t0_psnr_y": bt["t0.0"],
        "t05_psnr_y": bt["t0.5"],
        "t0_ssim_y": st.get("t0.0"),
        "t05_ssim_y": st.get("t0.5"),
    }


def aggregate(plain, modes, knobs) -> dict:
    """The artifact from the plain record, the other modes' records
    ({name: record}) and the stage-C knobs' records ({name: record})."""
    modes = {"plain": plain, **modes}
    t0_bar = plain.get("baseline_bicubic", {}).get("t0_psnr", 35.405)
    summary = {}
    for name, rec in modes.items():
        row = _times(rec)
        row["clears_t0_vs_bicubic"] = bool(row["t0_psnr_y"] >= t0_bar)
        row["clears_t05"] = bool(row["t05_psnr_y"] >= T05_BAR)
        summary[name] = row

    agg = dict(plain)
    agg["decode_modes"] = summary
    headline = max(summary.items(),
                   key=lambda kv: (kv[1]["clears_t0_vs_bicubic"]
                                   and kv[1]["clears_t05"],
                                   kv[1]["t0_psnr_y"] + kv[1]["t05_psnr_y"]))
    agg["headline"] = {
        "mode": headline[0],
        # the headline names the best-sum mode even when none clears the
        # bars; the flag says whether it does
        "clears_mandate": bool(headline[1]["clears_t0_vs_bicubic"]
                               and headline[1]["clears_t05"]),
        **{k: headline[1][k] for k in ("t0_psnr_y", "t05_psnr_y")},
    }
    agg["mandate"] = {
        "t0_target_psnr_y": t0_bar,
        "t05_target_psnr_y": T05_BAR,
        "cleared_by": [n for n, r in summary.items()
                       if r["clears_t0_vs_bicubic"] and r["clears_t05"]],
    }
    knob_gates = {}
    for name, rec in knobs.items():
        row = _times(rec)
        knob_gates[name] = {
            "t0_psnr_y": row["t0_psnr_y"],
            "t05_psnr_y": row["t05_psnr_y"],
            "t0_delta_db": round(row["t0_psnr_y"]
                                 - summary["plain"]["t0_psnr_y"], 4),
            "t05_delta_db": round(row["t05_psnr_y"]
                                  - summary["plain"]["t05_psnr_y"], 4),
        }
    if knob_gates:
        agg["stagec_knob_gates"] = knob_gates
    if "bf16" in summary:
        agg["bf16_gate"] = {
            "t0_delta_db": round(summary["bf16"]["t0_psnr_y"]
                                 - summary["plain"]["t0_psnr_y"], 4),
            "t05_delta_db": round(summary["bf16"]["t05_psnr_y"]
                                  - summary["plain"]["t05_psnr_y"], 4),
            "target_abs_delta_db": 0.01,
        }
    return agg


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--plain", required=True)
    ap.add_argument("--bf16", default=None)
    ap.add_argument("--le", default=None)
    ap.add_argument("--le-se", dest="le_se", default=None)
    ap.add_argument("--stagec-dedup", dest="stagec_dedup", default=None)
    ap.add_argument("--stagec-nearest", dest="stagec_nearest", default=None)
    ap.add_argument("--stagec-fp8", dest="stagec_fp8", default=None)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    plain = _load(args.plain)
    if plain is None:
        raise SystemExit(f"plain eval record missing: {args.plain}")

    def loaded(pairs):
        return {name: rec for name, rec in
                ((name, _load(path)) for name, path in pairs)
                if rec is not None}

    agg = aggregate(
        plain,
        loaded((("bf16", args.bf16), ("localensemble", args.le),
                ("localensemble+self_ensemble", args.le_se))),
        loaded((("stagec_dedup", args.stagec_dedup),
                ("stagec_nearest", args.stagec_nearest),
                ("stagec_fp8", args.stagec_fp8))))
    with open(args.out, "w") as f:
        json.dump(agg, f, indent=2)
    print(json.dumps({"headline": agg["headline"],
                      "mandate": agg["mandate"],
                      "bf16_gate": agg.get("bf16_gate"),
                      "stagec_knob_gates": agg.get("stagec_knob_gates")},
                     indent=2))
    return agg


if __name__ == "__main__":
    main()
