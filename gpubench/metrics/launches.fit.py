"""CUDA kernel launches a fit step, counted from the device trace."""
from gpubench import readers


def read(record):
    return readers.launches(record)
