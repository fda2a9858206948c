"""Seconds from the harness's start to the window: imports, the card's
start, generation, ``Graph.from_coo``, contexts, captures and warm
runs."""


def read(rec):
    return rec.setup_s
