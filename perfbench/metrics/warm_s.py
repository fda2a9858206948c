"""Seconds from the built graph to the window: the programs, their
``EdgeContext``, and each program's warm runs, the first of which
captures its CUDA graph."""


def read(rec):
    return rec.warm_s
