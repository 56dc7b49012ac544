"""The card's idle share of the traced render window, in %."""
from h100bench.metrics._common import idle_share


def read(record):
    return idle_share(record)
