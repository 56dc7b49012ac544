"""Model FLOPs of the traced renders (forward only) over the window times the float32 peak, in %."""
from h100bench.metrics._common import mfu


def read(record):
    return mfu(record)
