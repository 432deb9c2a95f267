"""Peak device memory allocated by the process up to the close of the
measured window, in MiB."""
from gpubench import readers


def read(record):
    return readers.peak_mib(record)
