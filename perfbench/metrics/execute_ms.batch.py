"""execute_ms.batch: ms a formed batch spends in plan + candidates + execute: the executor and its stages, ending in the result download."""


def read(run):
    return run.per_batch_ms(("plan", "candidates", "execute"))
