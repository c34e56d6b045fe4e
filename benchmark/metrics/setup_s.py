"""setup_s: from the process's start to the first timed frame's
submission."""

UNIT = "s"


def read(run):
    return run["setup_s"]
