#!/usr/bin/env python
"""Training supervisor of the PyTorch/CUDA port (counterpart of
``scripts/train_supervisor.py``): stall detection and automatic resume.

It launches ``scripts/train_torch.py`` and watches ``train.log`` in the
config's ``path.models``. When the log has not changed for
``--stall-timeout`` seconds it kills the trainer and relaunches it with
``--resume`` from the latest checkpoint; a trainer that exits without
"done at step" as the log's last line is relaunched the same way. It gives
up after ``--max-restarts`` relaunches.

Usage:
  python scripts/train_supervisor_torch.py -opt CONFIG.yml \
      [--stall-timeout 600] [--poll 30] [--max-restarts 10] \
      [--adopt-pid PID] [-- ARGS FOR train_torch.py]

The trainer's output goes to ``train_stdout.log`` beside ``train.log``.
Returns 0 when training finished, 1 when it gave up.
"""

import argparse
import os
import signal
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

TRAINER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "train_torch.py")


def _log_mtime(path):
    try:
        return os.path.getmtime(path)
    except OSError:
        return 0.0


def _last_line(path):
    try:
        with open(path) as f:
            lines = f.readlines()
        return lines[-1] if lines else ""
    except OSError:
        return ""


def _pid_alive(pid):
    """Whether a process we did not start is running (a zombie is not)."""
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except OSError:
        return True


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-opt", required=True)
    ap.add_argument("--stall-timeout", type=float, default=600.0)
    ap.add_argument("--poll", type=float, default=30.0)
    ap.add_argument("--max-restarts", type=int, default=10)
    ap.add_argument("--adopt-pid", type=int, default=None,
                    help="supervise an already-running trainer first")
    ap.add_argument("rest", nargs="*",
                    help="arguments for the trainer (after --)")
    args = ap.parse_args(argv)

    from stif_tpu_torch.utils.config import parse_options

    opt = parse_options(args.opt, is_train=True)
    models_dir = (opt.get("path") or {}).get("models") or "."
    log_path = os.path.join(models_dir, "train.log")
    out_path = os.path.join(models_dir, "train_stdout.log")
    train_cmd = [sys.executable, TRAINER, "-opt", args.opt] + list(
        args.rest)

    def launch(resume: bool):
        os.makedirs(models_dir, exist_ok=True)
        with open(out_path, "ab") as out:
            p = subprocess.Popen(train_cmd + (["--resume"] if resume else []),
                                 stdout=out, stderr=subprocess.STDOUT)
        print(f"[supervisor] launched pid {p.pid} (resume={resume})",
              flush=True)
        return p

    adopted = args.adopt_pid if (args.adopt_pid
                                 and _pid_alive(args.adopt_pid)) else None
    proc = None if adopted else launch(resume=args.adopt_pid is not None)
    restarts = 0
    # the stall clock starts now: a train.log left by an earlier run must
    # not count against a trainer that is still starting
    last = time.time()
    try:
        while True:
            time.sleep(args.poll)
            m = _log_mtime(log_path)
            if m > last:
                last = m
            stalled = (time.time() - last) > args.stall_timeout
            dead = (proc.poll() is not None if proc is not None
                    else not _pid_alive(adopted))
            if dead:
                if "done at step" in _last_line(log_path):
                    print("[supervisor] training finished", flush=True)
                    return 0
                print("[supervisor] trainer died; resuming", flush=True)
            elif stalled:
                pid = proc.pid if proc is not None else adopted
                print(f"[supervisor] no progress for "
                      f"{time.time() - last:.0f}s; killing {pid}", flush=True)
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass
                if proc is not None:
                    proc.wait()
            else:
                continue
            restarts += 1
            if restarts > args.max_restarts:
                print("[supervisor] max restarts exceeded", flush=True)
                return 1
            proc, adopted = launch(resume=True), None
            last = time.time()
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()


if __name__ == "__main__":
    sys.exit(main())
