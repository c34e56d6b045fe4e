"""peak_mem_gib: torch.cuda.max_memory_allocated() from before the scene
is made to the end of the window, before the output check."""

UNIT = "GiB"


def read(run):
    return run["peak_bytes"] / 2**30 if run["peak_bytes"] else None
