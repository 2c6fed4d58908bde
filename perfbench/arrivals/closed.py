"""``closed``: one client keeps ``in_flight`` requests outstanding and sends
the next as each completes, from the future's completion callback, so a
formed batch's answers are replaced before the scheduler forms the next
batch."""
from perfbench import traffic


def validate(mix: dict) -> None:
    if int(mix.get("in_flight", 0)) < 1:
        raise ValueError("traffic: a closed loop needs in_flight >= 1")


def drive(mix: dict, client: "traffic.Client") -> "traffic.Window":
    return traffic.closed_loop(int(mix["in_flight"]), client)
