"""Seconds from the process's start to the first timed frame or step."""


def read(run):
    return run.setup_s
