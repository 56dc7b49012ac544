"""Arithmetic the per-layer readers share. Each reader file is
``<metric name>.py`` and defines ``read(record)``: the traced run's record
(``trace``: the window's reduction, ``counters``: the probes' counts) ->
a number, or None when the run holds nothing to read."""
from __future__ import annotations

from h100bench import counts, tracing

# the encode backward's kernels: the table-gradient scatter's stages and the
# coordinate backward
ENCODE_BWD_KERNELS = ("encode_dx_kernel", "shared_grad_kernel", "global_grad_kernel",
                      "float_grad_kernel", "window_grad_kernel", "finish_kernel",
                      "redo_kernel", "fix_kernel", "round_kernel", "dbary_kernel")
ENCODE_FWD_KERNELS = ("permuto_encode_kernel",)


def idle_share(record):
    tr = record.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (tr["window_s"] - tr["busy_s"]) / tr["window_s"]


def mfu(record):
    tr, c = record.get("trace"), record.get("counters")
    if not tr or not c or c["model_flops"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * c["model_flops"] / (tr["window_s"] * counts.F32_FLOPS_PER_S)


def roofline(record, prefix, kernels):
    tr, c = record.get("trace"), record.get("counters")
    if not tr or not c or c[prefix + "_bytes"] <= 0:
        return None
    t = tracing.seconds_of(tr["kernel_s"], kernels)
    if t <= 0:
        return None
    return 100.0 * counts.least_seconds(c[prefix + "_flops"], c[prefix + "_bytes"]) / t


def data_sample_ms(record):
    if not record.get("steps") or record.get("data_sample_s") is None \
            or record["data_sample_s"] <= 0:
        return None
    return 1e3 * record["data_sample_s"] / record["steps"]
