"""What the port's programs report of their own accounting: each line of
``outcome.notes["programs"]`` (``ProgramCache.stats()``) may hold
``stages`` ({stage: {'n', 'device_ms'}}, read off the card's stage-mark
table: the device time of each marked stage over the program's replays)
and ``host`` ({span: {'n', 'ms'}}: host spans of the calls that replayed
it, its first call left out). A program without them (a port that keeps
no such table) adds nothing, and a reader then finds None."""

from __future__ import annotations

# the host's own work in a steady call: not the waits for the device
# (``fetch.wait``), not ``launch.replay`` (``graph_launch_ms`` times it)
HOST_WORK = ("stage.pad", "stage.upload", "launch.copy_in", "fetch.copy",
             "train.feed", "train.logs")


def programs(outcome) -> list:
    return (outcome.notes or {}).get("programs") or []


def stage_ms(outcome, stage: str):
    """Device ms per opening of ``stage``, summed over the programs and
    divided by their summed counts; None where none reports it."""
    n = ms = 0
    for p in programs(outcome):
        row = (p.get("stages") or {}).get(stage)
        if row:
            n += row["n"]
            ms += row["device_ms"]
    return ms / n if n else None


def host_ms(outcome, spans=HOST_WORK):
    """Host ms per steady call in ``spans``, summed over the programs and
    divided by their steady calls (the count of ``launch.copy_in``); None
    where no program reports one."""
    n = ms = 0
    for p in programs(outcome):
        host = p.get("host") or {}
        calls = host.get("launch.copy_in", {}).get("n", 0)
        if calls:
            n += calls
            ms += sum(host[s]["ms"] for s in spans if s in host)
    return ms / n if n else None
