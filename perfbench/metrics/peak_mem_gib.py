"""peak_mem_gib: torch.cuda.max_memory_allocated() over set-up and window,
in GiB: the device memory the deployment needs."""


def read(run):
    return run.memory_peak_bytes / 2 ** 30
