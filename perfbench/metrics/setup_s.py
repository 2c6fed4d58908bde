"""setup_s: seconds from the process's start to the window's start: imports,
the lake drawn on the card, ingest, the engine opened and warmed."""


def read(run):
    return run.setup_s
