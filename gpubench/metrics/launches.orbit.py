"""CUDA kernel launches a frame, counted from the device trace."""
from gpubench import readers


def read(record):
    return readers.launches(record)
