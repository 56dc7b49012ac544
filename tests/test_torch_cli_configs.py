"""The configs this slice unlocks, through the port's command line on the
CPU at tiny widths (4 LoDs x 2^8, hidden 16, 16 steps, 16 rays x 4 images):

- ``configs/bup20/panoptic_dd.yaml`` (``PanopticDDensityNeF`` under the DD
  tracer) and ``configs/bup20/mean_shift_contrastive.yaml``
  (``MeanShiftPanopticDeltaNeF``, ``sup_contrastive``, the validation's
  mean shift) over a 16x12 BUP20-format tree of the synthetic scene
  (``data/bup20_tree.py``): an RGB epoch, a panoptic epoch, a validation at
  val_mip 2 and the final one; finite losses and metrics;
- ``configs/bup20/lin_assign_delta_app.yaml`` (the DD tracer over a delta
  NeF, ``valid_every`` 1) over a NeRF-standard tree without labels, so no
  panoptic channel is asked for, through its last epoch.
"""
import json
import os

import numpy as np
import pytest
import torch

from pagnerf_tpu_torch import cli
from pagnerf_tpu_torch.train import validation as val_t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--num-lods", "4", "--capacity-log-2", "8",
        "--delta-capacity-log-2", "8", "--hidden-dim", "16", "--sem-hidden-dim", "16",
        "--inst-hidden-dim", "16", "--num-steps", "16", "--num-rays-sampled-per-img", "16",
        "--batch-size", "4", "--render-batch", "64"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A 16x12 BUP20 tree and a 16x12 NeRF-standard tree of 2 + 2 RGBA frames."""
    from pagnerf_tpu_torch.data.bup20_tree import write_bup20_tree
    from pagnerf_tpu_torch.utils.visualization import write_png
    bup20 = tmp_path_factory.mktemp("tiny") / "BUP_20"
    write_bup20_tree(str(bup20), width=16, height=12, supersample=1)
    nerf = tmp_path_factory.mktemp("nerf")
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        frames = []
        for i in range(2):
            write_png(str(nerf / f"{split}_{i}.png"),
                      rng.integers(0, 256, (12, 16, 4)).astype(np.uint8))
            c2w = np.eye(4)
            c2w[:3, 3] = [0.1 * i, 0.0, 1.0]
            frames.append({"file_path": f"{split}_{i}", "transform_matrix": c2w.tolist()})
        (nerf / f"transforms_{split}.json").write_text(
            json.dumps({"camera_angle_x": 0.8, "frames": frames}))
    return {"bup20": bup20, "standard": nerf}


def _epochs(tmp_path):
    (run,) = [os.path.join(r, d) for r, ds, _ in os.walk(tmp_path) for d in ds
              if os.path.exists(os.path.join(r, d, "events.jsonl"))]
    with open(os.path.join(run, "events.jsonl")) as f:
        return run, [json.loads(line) for line in f]


@pytest.mark.parametrize("name", ["panoptic_dd", "mean_shift_contrastive"])
def test_cli_trains_bup20_config(name, trees, tmp_path, monkeypatch):
    fits = []
    train_clustering = val_t.train_clustering

    def spy(*args, **kwargs):
        ms = train_clustering(*args, **kwargs)
        fits.append(ms)
        return ms
    monkeypatch.setattr(val_t, "train_clustering", spy)
    path = os.path.join(ROOT, "configs", "bup20", f"{name}.yaml")
    metrics = cli.main(["--config", path, "--dataset-path", str(trees["bup20"]),
                        "--dataset-center-idx", "0", "--log-dir", str(tmp_path),
                        "--epochs", "2", "--sem-epoch-start", "1", "--inst-epoch-start", "1",
                        "--valid-every", "2", "--val-mip", "2"] + TINY)
    assert all(np.isfinite(v) for v in metrics.values())
    assert {"val/psnr", "val/iou", "val/pq_things", "val/map"} <= set(metrics)
    if name == "mean_shift_contrastive":
        # the validation at epoch 2 and the final one fit the mean shift
        assert len(fits) == 2 and all(ms is not None and ms.ms is not None for ms in fits)
    else:
        assert not fits
    run, events = _epochs(tmp_path)
    losses = [e for e in events if "inst_loss" in json.dumps(e)]
    assert losses, "no panoptic epoch logged"
    assert os.path.exists(os.path.join(run, "model.ckpt"))


def test_cli_trains_lin_assign_delta_app_to_its_last_epoch(trees, tmp_path):
    path = os.path.join(ROOT, "configs", "bup20", "lin_assign_delta_app.yaml")
    metrics = cli.main(["--config", path, "--dataset-path", str(trees["standard"]),
                        "--log-dir", str(tmp_path), "--epochs", "2"] + TINY)
    assert np.isfinite(metrics["val/psnr"])
    run, _ = _epochs(tmp_path)
    state = torch.load(os.path.join(run, "model.ckpt"), weights_only=True)
    assert state["epoch"] == 2
