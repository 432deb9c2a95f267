"""K1's share of its roofline in the orbit's traced frames: the bound of
the samples the benchmark's reference counts for each frame it checked,
over K1's device time in those frames."""
from gpubench import readers


def read(record):
    return readers.roofline(record, "K1")
