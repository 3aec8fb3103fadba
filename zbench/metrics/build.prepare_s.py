"""Seconds of the first full prepare of the head snapshot (host build and
the copy to the card), on the harness's clock."""


def read(run):
    return run.prepare_s
