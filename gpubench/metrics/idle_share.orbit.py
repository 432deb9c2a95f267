"""Percent of the traced window in which the device ran nothing."""
from gpubench import readers


def read(record):
    return readers.idle_share(record)
