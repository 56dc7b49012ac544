"""The trainer's own data_sample phase (PerfTimer), mean ms a step of the traced window."""
from h100bench.metrics._common import data_sample_ms


def read(record):
    return data_sample_ms(record)
