"""K4's share of its roofline in the fit's traced steps: the bound of every
sample of every ray at eps 0 (those inside the dataset counted by the
benchmark's reference), over K4's device time."""
from gpubench import readers


def read(record):
    return readers.roofline(record, "K4")
