"""Model FLOPs of the traced training steps (decoders and heads forward and backward on the samples the march keeps, the encodes' lattice and weighted sums) over the window times the float32 peak, in %."""
from h100bench.metrics._common import mfu


def read(record):
    return mfu(record)
