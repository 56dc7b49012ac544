"""The per-layer arithmetic on a recorded trace: the window's busy union,
idle gaps and their labels, and the readers' idle share, mfu and roofline
shares from the yardstick's counts."""
import numpy as np
import pytest

from h100bench import counts, harness, tracing
from h100bench.tests.tiny import REPO

MS = 1_000_000     # ns


def _fixture():
    """A 10 ms window: an encode kernel 0-2 ms, a scatter 1-3 ms (overlap),
    encode_dx 3-4 ms, a copy 6-7 ms, a kernel outside the window; the host
    in a readback 4-6 ms and sampling 7-10 ms."""
    return {
        "annotations": [(tracing.WINDOW, 0, 10 * MS), ("bench.train_step", 3 * MS, 6 * MS),
                        ("bench.sample_batch", 7 * MS, 10 * MS)],
        "host": [("aten::item", 4 * MS, 6 * MS), ("aten::copy_", 7 * MS, 8 * MS),
                 ("aten::index", 7 * MS, 10 * MS)],
        "device": [("void (anonymous namespace)::permuto_encode_kernel<float, 2>(Levels)", 0,
                    2 * MS),
                   ("void (anonymous namespace)::global_grad_kernel<2>(int const*)", 1 * MS,
                    3 * MS),
                   ("void (anonymous namespace)::encode_dx_kernel<float>(Levels)", 3 * MS,
                    4 * MS),
                   ("Memcpy HtoD (Pinned -> Device)", 6 * MS, 7 * MS),
                   ("void other_kernel(float*)", 11 * MS, 12 * MS)]}


def test_summary_of_a_recorded_trace():
    s = tracing.summarize(_fixture())
    assert s["window_s"] == pytest.approx(0.010)
    assert s["busy_s"] == pytest.approx(0.005)
    assert [round(g[1], 6) for g in s["idle_gaps"]] == [0.003, 0.002]
    assert s["idle_gaps"][0][0] == "bench.sample_batch > aten::index"
    assert s["idle_gaps"][1][0] == "bench.train_step > aten::item"
    assert s["device_ops"][0][1] == pytest.approx(0.002)
    assert tracing.seconds_of(s["kernel_s"], ["encode_dx_kernel", "global_grad_kernel"]) \
        == pytest.approx(0.003)


def test_a_card_only_window_takes_the_hosts_length():
    """With the card's activity alone the trace holds no annotation: the
    window is the host's clock from the card's first operation, and every
    operation lies in it."""
    events = {**_fixture(), "annotations": [], "host": []}
    s = tracing.summarize(events, window_s=0.015)
    assert s["window_s"] == pytest.approx(0.015)
    assert s["busy_s"] == pytest.approx(0.006)
    assert s["idle_gaps"][0] == ["host", pytest.approx(0.004)]
    with pytest.raises(ValueError):
        tracing.summarize(events)


def _record(counters):
    return {"trace": tracing.summarize(_fixture()), "counters": counters, "steps": 4,
            "data_sample_s": 0.012}


def _read(name, record):
    return harness.metric_reader(REPO, name)(record)


def test_readers_on_the_recorded_trace():
    c = {"model_flops": 6.7e9, "encode_fwd_bytes": 3.35e9, "encode_fwd_flops": 1e6,
         "encode_bwd_bytes": 0.67e9, "encode_bwd_flops": 1e6}
    rec = _record(c)
    assert _read("idle_share.train", rec) == pytest.approx(50.0)
    # 6.7e9 FLOPs over 10 ms at 67 TFLOP/s
    assert _read("mfu.train", rec) == pytest.approx(1.0)
    # 3.35 GB at 3.35 TB/s is 1 ms against the encode's 2 ms
    assert _read("roofline.encode_fwd.train", rec) == pytest.approx(50.0)
    # 0.67 GB is 0.2 ms against the scatter's 2 ms and encode_dx's 1 ms
    assert _read("roofline.encode_bwd.train", rec) == pytest.approx(100 * 0.2 / 3.0)
    assert _read("data_sample_ms.train", rec) == pytest.approx(3.0)


def test_readers_return_nothing_without_a_reading():
    empty = {"trace": None, "counters": None, "steps": 0, "data_sample_s": 0.0}
    for name in ("idle_share.train", "mfu.train", "roofline.encode_fwd.train",
                 "roofline.encode_bwd.train", "data_sample_ms.train", "mfu.render"):
        assert _read(name, empty) is None
    no_kernel = _record({"model_flops": 0.0, "encode_fwd_bytes": 1e9, "encode_fwd_flops": 0.0,
                         "encode_bwd_bytes": 0.0, "encode_bwd_flops": 0.0})
    no_kernel["trace"]["kernel_s"] = {}
    assert _read("roofline.encode_fwd.train", no_kernel) is None
    assert _read("mfu.train", no_kernel) is None


def test_encode_counts_from_the_functions_inputs_and_outputs():
    n, scales = 1 << 20, np.geomspace(1.0, 1e-4, 24)
    reach = counts.permuto_reachable_rows(scales, 1 << 18)
    assert reach.shape == (24,) and reach.max() == 1 << 18 and reach.min() < 1 << 18
    fw = counts.encode_fwd_work(n, reach, 2, 1)
    rows = np.minimum(reach, 4 * n).sum()
    assert fw["bytes"] == 12 * n + rows * 2 * 4 + 24 * 2 * 4 * n
    dual = counts.encode_fwd_work(n, reach, 2, 2)
    assert dual["bytes"] - fw["bytes"] == rows * 8 + 24 * 8 * n


def test_encode_backward_count_does_not_depend_on_the_implementation():
    """The coordinate backward reads the cotangent, the coordinates and table
    A's rows and writes dx whether one kernel forms it (``encode_dx``) or the
    plain composition does (the weights' gradient, then the lattice's
    backward): its count is the function's, from N, the levels and F."""
    import torch
    from pagnerf_tpu_torch.ops import permuto_encoding as pe
    from pagnerf_tpu_torch.ops import table_gather as tg
    n, scales, cap = 300, np.geomspace(1.0, 1e-2, 4), 1 << 10
    tables = torch.rand(4, cap, 2)
    x = torch.rand(3, n) * 2 - 1
    st = pe.level_statics(scales, cap, 2)
    idx, bary, rank = pe._lattice_levels(x, st.log2_c, st.inv_scales,
                                         st.mm, st.dm, st.direct)
    g = torch.rand(4, 2, n)
    one = pe.encode_dx_plain(tables, idx, rank, g, st.inv_scales, tables.dtype)
    two = pe._lattice_levels_dx(x, st.inv_scales, tg.gather_dbary_plain(tables, idx, g), rank)
    assert one.shape == two.shape == x.shape
    reach = counts.permuto_reachable_rows(scales, cap)
    works = {counts.encode_bwd_work(out.shape[1], reach, cap, g.shape[1], 1, True)["bytes"]
             for out in (one, two)}
    assert len(works) == 1
    # idx, bary and rank, which an implementation may keep, count nowhere
    assert counts.encode_bwd_work(n, reach, cap, 2, 1, True)["bytes"] == \
        12 * n + 4 * 2 * 4 * n + 4 * cap * 2 * 4 + np.minimum(reach, 4 * n).sum() * 8 + 12 * n
