"""Device ms a fit step of every operation that is none of the hand-written
kernels K1-K9: prep, bakes, autograd, the optimizer, copies."""
from gpubench import readers


def read(record):
    return readers.other_device_ms(record)
