"""engine_host_ms.batch: ms a formed batch spends in pin + resolve + finalize: the engine's host work."""


def read(run):
    return run.per_batch_ms(("pin", "resolve", "finalize"))
