"""Whole runs of tiny cells on the CPU (the harness's look for a card
skipped): the cells, mixes and metrics found by name, a cell added as files
only, the reference against the program's CPU path, the control and the
faults that must come out as not correct."""
import json
import os
import shutil

import pytest
import torch

from h100bench import control, run
from h100bench.tests.tiny import BENCH, make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("tiny")))


def _run(root, cell, trace=0, seed=2147483711, **kw):
    line, checks = run.measure(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                                "--trace", str(trace)], root=root, allow_cpu=True, **kw)
    return json.loads(line)


@pytest.mark.parametrize("cell", ["pagnerf_best.train_panoptic", "panoptic_nerf_hash.train",
                                  "pagnerf_best.train_rgb_dense", "pagnerf_best.render_val"])
def test_cell_is_correct_against_the_reference(root, cell):
    out = _run(root, cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) >= {"setup_s"} and len(out["metrics"]) >= 2
    assert all(v["value"] > 0 for v in out["metrics"].values())


def test_traced_run_reports_its_window(root):
    out = _run(root, "pagnerf_best.train_rgb_dense", trace=1)
    assert out["correct"]
    assert out["device"]["window_s"] > 0 and "breakdown" in out
    # the CPU has no device trace: only the host span's metric is read
    assert set(out["metrics"]) == {"data_sample_ms.train"}


def test_a_cell_added_as_files_only(root, tmp_path):
    new = str(tmp_path / "checkout")
    shutil.copytree(root, new)
    bench = json.load(open(os.path.join(new, "BENCHMARK.json")))
    traffic = json.load(open(os.path.join(BENCH, "traffic", "train_rgb_dense.json")))
    traffic.update(epoch=151, trace_epochs=1)
    with open(os.path.join(new, "h100bench", "traffic", "train_rgb_late.json"), "w") as f:
        json.dump(traffic, f)
    shutil.copy(os.path.join(new, "h100bench", "limits", "pagnerf_best.train_rgb_dense.json"),
                os.path.join(new, "h100bench", "limits", "pagnerf_best.train_rgb_late.json"))
    with open(os.path.join(new, "h100bench", "metrics", "steps_in_window.train.py"), "w") as f:
        f.write('"""Steps in the traced window."""\n\n\ndef read(record):\n'
                '    return float(record["steps"])\n')
    name = "pagnerf_best.train_rgb_late"
    bench["workloads"].append({"name": name, "config": "pagnerf_best",
                               "traffic": "train_rgb_late", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_rays_per_s":
            m["workloads"].append(name)
    bench["per_layer"].append({"name": "steps_in_window.train", "unit": "steps",
                               "better": "higher", "source": "host_clock", "layer": "test",
                               "moves": "train_rays_per_s", "workloads": [name]})
    with open(os.path.join(new, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    assert _run(new, name)["correct"]
    out = _run(new, name, trace=1)
    assert out["metrics"]["steps_in_window.train"]["value"] >= 1


@pytest.mark.parametrize("cell,fault", [
    ("pagnerf_best.train_rgb_dense", "control"), ("pagnerf_best.render_val", "control"),
    ("pagnerf_best.train_rgb_dense", "unchanged"), ("pagnerf_best.train_panoptic", "unchanged"),
    ("pagnerf_best.train_panoptic", "half_batch"), ("panoptic_nerf_hash.train", "half_batch"),
    ("pagnerf_best.render_val", "altered")])
def test_the_control_and_the_faults_are_not_correct(root, cell, fault, tf32_on_cpu):
    """The control (on the CPU the decoders' matmul operands rounded to
    TF32) and each fault a cell can have, planted as ``h100bench.control``
    plants them on the card; the reference follows a half batch's steps."""
    with control.planted(fault) as kw:
        out = _run(root, cell, **kw)
    assert not out["correct"], out["checks"]
    values = [c["value"] for c in out["checks"].values()]
    if fault == "unchanged":
        assert max(values) >= 0.5
    if fault == "half_batch":
        assert 0 < max(values) < 1e29


@pytest.mark.cuda
def test_tiny_cells_on_the_card(root, card):
    for cell in ("pagnerf_best.train_panoptic", "pagnerf_best.render_val"):
        out = _run(root, cell)
        assert out["correct"], out["checks"]
        assert out["device"]["platform"] == "gpu"
