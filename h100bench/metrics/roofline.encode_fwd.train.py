"""The fused encode's least time by the yardstick's counts over its kernels' device time, training, in %."""
from h100bench.metrics._common import roofline, ENCODE_FWD_KERNELS


def read(record):
    return roofline(record, 'encode_fwd', ENCODE_FWD_KERNELS)
