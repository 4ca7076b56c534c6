"""setup_s: process start to the window's start, on the host clock, without
the check's reading of the program's state."""


def read(record):
    return record["setup_s"]
