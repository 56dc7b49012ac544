"""The port's command line (``pagnerf_tpu_torch.cli``) and the quality-run
script's helpers, on the CPU.

- ``cli.main`` on ``configs/synthetic/tiny.yaml`` with ``--device cpu``
  trains its 6 epochs (the panoptic heads from epoch 2) and writes
  ``events.jsonl``, ``config.yaml``, ``log.txt``, ``metrics.csv`` and
  ``model.ckpt`` in its run directory; the snapshot parses back to the run's
  namespace; with ``--perf`` the trainer's timer writes each step, prune,
  epoch and validation to ``perf.jsonl``.
- ``--valid-only --pretrained`` that checkpoint reproduces the final
  validation's metrics exactly (the render time apart); ``--save-map-only``
  writes the point-cloud map.
- Without a card and without ``--device cpu`` it refuses; the entry flags
  run their modes: ``--render-views`` writes every view's channel PNGs
  under ``<run dir>/views``, ``--viewer`` serves (its loop patched to
  return); ``--validate-dataset`` refuses only a format it cannot check,
  and as a command exits with 1 on any error, as ``main.py`` does.
- ``quality_run``'s record reader, the stages' labels, its summary of the
  timer's records, and ``pose_drift`` on a checkpoint with a camera turned
  by a known angle.
"""
import glob
import json
import os
import pickle

import numpy as np
import pytest
import torch

from pagnerf_tpu_torch import cli, quality_run
from pagnerf_tpu_torch.config import config as config_t
from pagnerf_tpu_torch.train.trainer import StageConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "synthetic", "tiny.yaml")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops in one thread: beside five busy test workers, torch's
    spinning intra-op threads took a 5 s tiny CLI run to 293 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_dir(root) -> str:
    """The one run directory ``cli.main`` made under ``root``."""
    (d,) = glob.glob(os.path.join(str(root), "*", "*", ""))
    return d.rstrip(os.sep)


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("runs")
    metrics = cli.main(["--config", TINY, "--device", "cpu", "--log-dir", str(root),
                        "--perf"])
    return root, metrics, run_dir(root)


def test_cli_trains_and_writes_its_run_directory(tiny_run):
    root, metrics, log_dir = tiny_run
    assert os.path.dirname(os.path.dirname(log_dir)) == str(root)
    assert os.path.basename(os.path.dirname(log_dir)) == "synthetic_tiny"
    for name in ("events.jsonl", "config.yaml", "log.txt", "metrics.csv", "model.ckpt",
                 "perf.jsonl"):
        assert os.path.getsize(os.path.join(log_dir, name)) > 0, name
    state = torch.load(os.path.join(log_dir, "model.ckpt"), weights_only=True)
    steps_per_epoch = 2           # tiny.yaml: 4 training views, batch 2
    assert state["epoch"] == 6 and state["global_step"] == 6 * steps_per_epoch
    with open(os.path.join(log_dir, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    tags = {e["tag"] for e in events}
    assert {"Loss/rgb_loss", "Loss/sem_loss", "Loss/inst_loss", "val/psnr"} <= tags
    assert sorted({e["step"] for e in events if e["tag"] == "Loss/rgb_loss"}) == list(range(6))
    assert {"val/psnr", "val/iou", "val/pq_things", "val/map"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())
    args = config_t.parse_options(["--config", os.path.join(log_dir, "config.yaml")])
    want = config_t.parse_options(["--config", TINY, "--log-dir", str(root), "--perf"])
    drop = ("config", "help")
    assert ({k: v for k, v in vars(args).items() if k not in drop}
            == {k: v for k, v in vars(want).items() if k not in drop})
    with open(os.path.join(log_dir, "log.txt")) as f:
        text = f.read()
    assert "EPOCH 5/6" in text and "saved checkpoint" in text


def test_perf_records_each_step_prune_epoch_and_validation(tiny_run):
    _, metrics, log_dir = tiny_run
    _, records = quality_run.read_perf(os.path.dirname(os.path.dirname(log_dir)),
                                       "synthetic_tiny")
    by_name = {}
    for r in records:
        by_name.setdefault(r["name"], []).append(r)
        assert r["ms"] >= 0
    assert sorted(by_name) == ["data_sample", "epoch", "train_step", "validate"]
    steps = by_name["train_step"]
    assert [s["epoch"] for s in steps] == [e for e in range(6) for _ in range(2)]
    assert {s["stage"] for s in steps if s["epoch"] < 2} == {"ray_dense_rgb"}
    assert {s["stage"] for s in steps if s["epoch"] >= 2} == {"ray_dense_panoptic"}
    assert all(len(s["cam_idx"]) == 2 and s["rays"] > 0 for s in steps)
    assert [e["epoch"] for e in by_name["epoch"]] == list(range(6))
    assert all(np.isfinite(e["losses"]["rgb_loss"]) for e in by_name["epoch"])
    # tiny.yaml validates every 6 epochs: after epoch 5, then the final one
    assert [v["epoch"] for v in by_name["validate"]] == [5, 6]
    assert by_name["validate"][-1]["metrics"] == metrics


def test_valid_only_reproduces_the_final_metrics(tiny_run, tmp_path):
    _, metrics, log_dir = tiny_run
    again = cli.main(["--config", TINY, "--device", "cpu", "--log-dir", str(tmp_path),
                      "--valid-only", "--pretrained", os.path.join(log_dir, "model.ckpt")])
    assert sorted(again) == sorted(metrics)
    for k, v in metrics.items():
        if k != "val/render_time_per_img":
            assert again[k] == v, k


def test_save_map_only_writes_the_map(tiny_run, tmp_path):
    _, _, log_dir = tiny_run
    out = cli.main(["--config", TINY, "--device", "cpu", "--log-dir", str(tmp_path),
                    "--save-map-only", "--pretrained", os.path.join(log_dir, "model.ckpt")])
    with open(os.path.join(run_dir(tmp_path), "nerf_pc.pkl"), "rb") as f:
        saved = pickle.load(f)
    assert sorted(saved) == sorted(out) and saved["points"].shape[1:] == (3,)


def test_cli_refuses_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", TINY, "--log-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("flag", ["--render-views", "--viewer", "--validate-dataset"])
def test_cli_refuses_unported_entry_flags(flag, tmp_path, capsys, monkeypatch):
    """Each entry flag runs its mode (none is refused since the apps are
    ported; the name is kept)."""
    argv = ["--config", TINY, "--device", "cpu", "--log-dir", str(tmp_path), flag]
    if flag == "--validate-dataset":
        # it refuses only a format the validator does not know, with one
        # error, as the JAX package's run_validation does
        assert cli.main(argv + ["--multiview-dataset-format", "replica"]) == 1
        assert "does not support format 'replica'" in capsys.readouterr().out
        assert cli.main(argv) == 0 and not os.listdir(tmp_path)
        return
    if flag == "--viewer":
        from http.server import ThreadingHTTPServer
        monkeypatch.setattr(ThreadingHTTPServer, "serve_forever", lambda self, *a, **k: None)
        assert cli.main(argv + ["--viewer-port", "0"]) is None
        assert "# viewer: http://0.0.0.0:" in capsys.readouterr().out
        return
    frames = cli.main(argv)
    views = os.path.join(run_dir(tmp_path), "views")
    assert sorted(frames) == ["depth", "instance", "rgb", "semantics"]
    n = len(frames["rgb"])
    assert n >= 2 and all(len(f) == n for f in frames.values())
    assert len(glob.glob(os.path.join(views, "*_*.png"))) == 4 * n


def test_device_flag_is_split_off():
    assert cli.split_device(["--config", "x", "--device", "cpu", "--lr", "1"]) == (
        "cpu", ["--config", "x", "--lr", "1"])
    assert cli.split_device(["--config", "x"]) == ("cuda", ["--config", "x"])


# ------------------------------------------------------------ quality_run
def test_quality_record_and_band():
    rec = quality_run.read_record()
    assert sorted(rec) == [19, 39, 59, 69]
    assert round(rec[69]["val/psnr"], 2) == 18.11 and round(rec[69]["val/iou"], 3) == 0.706
    assert round(rec[69]["val/pq_things"], 3) == 0.454 and round(rec[69]["val/map"], 3) == 0.228
    assert sorted(rec[19]) == ["val/psnr", "val/render_time_per_img"]
    assert quality_run.BAND == {"val/psnr": 1.0, "val/iou": 0.03, "val/pq_things": 0.05,
                                "val/map": 0.05}
    assert os.path.exists(quality_run.CONFIG)


def _stage(**kw):
    base = dict(channels=frozenset({"rgb"}), raymarch_type="ray", num_steps=96,
                compact_steps=0, pack_steps=0, use_sem=False, use_inst=False,
                use_inst_segment_reg=False, training_val_poses=False, extrinsics_on=True)
    return StageConfig(**{**base, **kw})


def test_quality_stage_names_and_summary():
    assert _stage().label == "ray_dense_rgb"
    assert _stage(pack_steps=24, raymarch_type="voxel", use_sem=True,
                  channels=frozenset({"rgb", "semantics"})).label == "voxel_packed_panoptic"
    assert _stage(compact_steps=48, channels=frozenset({"rgb", "inst_embedding"})
                  ).label == "ray_compact_panoptic"
    assert _stage(training_val_poses=True).label == "val_pose"
    records = [dict(name="train_step", epoch=e, stage=s, pack_steps=p, rays=4096, ms=ms)
               for e, s, p, ms in (
                   (0, "ray_dense_rgb", 0, 300.0), (0, "ray_dense_rgb", 0, 100.0),
                   (0, "ray_dense_rgb", 0, 120.0), (1, "ray_packed_rgb", 24, 90.0),
                   (2, "voxel_packed_rgb", 16, 80.0))]
    records += [dict(name="epoch", epoch=e, ms=s_ * 1e3, losses={})
                for e, s_ in ((0, 2.0), (1, 1.0), (2, 3.0))]
    records += [dict(name="prune", epoch=1, seed=True, refresh=False, ms=50.0, kept_share=0.3),
                dict(name="prune", epoch=1, seed=False, refresh=False, ms=60.0,
                     kept_share=0.1),
                dict(name="validate", epoch=2, ms=1.5e3,
                     metrics={"val/render_time_per_img": 0.01})]
    totals = {"train": {"calls": 2, "rays": 8, "budget": 40, "valid": torch.tensor(50),
                        "kept": torch.tensor(40), "truncated_rays": torch.tensor(2)}}
    out = quality_run.summary(records, totals)
    assert out["stages"]["ray_dense_rgb"] == {"steps": 3, "median_ms": 110.0,
                                              "first_ms_max": 300.0, "B": []}
    assert out["stages"]["voxel_packed_rgb"]["B"] == [16 * 4096]
    assert [p["next_B"] for p in out["prunes"]] == [24 * 4096, 16 * 4096]
    assert out["epoch_s"] == {"median": 2.0, "min": 1.0, "max": 3.0, "sum": 6.0}
    assert out["validations"] == [{"epoch": 2, "s": 1.5, "render_time_per_img_s": 0.01}]
    assert out["packing"]["train"]["truncated_ray_share"] == 0.25
    assert out["packing"]["train"]["kept_sample_share"] == 0.8


def test_quality_packing_spy_runs_a_packed_step():
    """``quality_run.packing`` around a packed training step of the tiny
    flagship (two microbatches after a prune and the scene fixture): the
    step goes through the spy, whose call follows ``pack_samples``', and
    the totals count both layouts."""
    from pagnerf_tpu_torch import entry
    cfg = dict(batch_size=2, num_rays_sampled_per_img=32, micro_batch_imgs=1,
               sem_epoch_start=0, inst_epoch_start=0, prune_every=-1,
               optimize_val_extrinsics=False, voxel_raymarch_epoch_start=0)
    spec = {"tiny": True, "device": "cpu", "compute_dtype": "float32", "occ_level": 5,
            "cfg": cfg, "actions": [{"do": "prune"}, {"do": "fixture"},
                                    {"do": "step", "epoch": 2}]}
    totals = {}
    with quality_run.packing(totals):
        out = entry.data_parallel_run(None, spec)
    assert out["actions"][-1]["stage"] == "voxel_packed_panoptic"
    assert totals["train"]["calls"] == 2 and totals["train"]["rays"] == 64
    assert 0 < int(totals["train"]["kept"]) <= totals["train"]["budget"]


def test_quality_pose_drift_reads_the_checkpoint(tiny_run, tmp_path):
    """``pose_drift``: train camera 2 turned by 2 degrees about its own
    centre (the centre stays) is reported so; the anchor camera 0 has not
    moved."""
    from pagnerf_tpu_torch.config.factory import load_dataset
    from pagnerf_tpu_torch.core.camera import extrinsics_params_from_view_matrix
    _, _, log_dir = tiny_run
    argv = ["--config", TINY]
    state = torch.load(os.path.join(log_dir, "model.ckpt"), weights_only=True)
    ds = load_dataset(config_t.parse_options(argv))
    views = torch.from_numpy(ds.data["view_matrices"]).double()
    a = np.deg2rad(2.0)
    turn = torch.tensor([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                         [0.0, 0.0, 1.0]], dtype=torch.float64)
    views[2, :3, :3] = turn @ views[2, :3, :3]
    views[2, :3, 3] = turn @ views[2, :3, 3]
    state["params"]["extrinsics"] = extrinsics_params_from_view_matrix(views).float()
    torch.save(state, tmp_path / "turned.ckpt")
    out = quality_run.pose_drift(str(tmp_path / "turned.ckpt"), argv)
    assert 2 in ds.train_idxs and out["epoch"] == state["epoch"]
    assert out["train"]["cameras"] == len(ds.train_idxs)
    assert out["train"]["rotation_deg"]["max_camera"] == 2
    np.testing.assert_allclose(out["train"]["rotation_deg"]["max"], 2.0, rtol=1e-3)
    assert out["train"]["centre_shift"]["max"] < 1e-5
    assert out["camera0"]["rotation_deg"] < 0.05 and out["camera0"]["centre_shift"] < 1e-5
