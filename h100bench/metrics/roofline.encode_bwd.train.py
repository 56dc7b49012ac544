"""The encode backward's least time (table gradients, coordinate backward) over its kernels' device time, in %."""
from h100bench.metrics._common import roofline, ENCODE_BWD_KERNELS


def read(record):
    return roofline(record, 'encode_bwd', ENCODE_BWD_KERNELS)
