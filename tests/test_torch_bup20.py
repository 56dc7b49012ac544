"""The port's BUP20 format (``data/formats/{bup20,agrobot_base,coco}.py``,
``data/validate.py``) against the JAX package's, on the CPU, on the on-disk
fixture of ``tests/test_bup20_format.py`` (16x12, 85 frames, written with
PIL and PyYAML), extended with the other prediction payloads (UNet
``.pkl.bz2`` of torch tensors, MaskRCNN, DeepLab), an RLE annotation in
both encodings, an ASCII PLY mesh and a palette robot mask.

- ``load_data``: every key equal to the JAX one for the window, load-modes,
  depth-filter, robot-mask, PLY and inference cases; images, labels and
  predictions exactly, depths and confidences within rtol 1e-6, view
  matrices and rays within atol 1e-6, the rest equal.
- The window datasets (``BUP20SequenceDataset``, ``BUP20InferenceDataset``
  with CSV and NPZ odometry, every prediction payload): every frame's
  arrays equal.
- ``validate_bup20_tree``: the same issue list on the clean tree and on
  every breakage of ``tests/test_bup20_format.py``; ``cli.main
  --validate-dataset`` returns the error count.
- ``load_dataset`` of a ``bup20`` namespace: the port's ``MultiviewDataset``
  samples the JAX one's batches (the JAX sampler's numpy fallback, same
  seed) and serves its ``get_images`` at mip 0-2 (images within 1e-6 of
  cv2's area filter, labels equal).
- ``cli.main`` on ``configs/bup20/best.yaml`` over the fixture at tiny
  widths trains one epoch on the CPU and writes a checkpoint.
"""
import bz2
import glob
import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch
from test_bup20_format import CENTER, H, NUM_FRAMES, W, bup20_root  # noqa: F401

from pagnerf_tpu.config import config as config_j
from pagnerf_tpu.config import factory as factory_j
from pagnerf_tpu.data import native as native_j
from pagnerf_tpu.data import validate as validate_j
from pagnerf_tpu.data.formats import agrobot_base as agro_j
from pagnerf_tpu.data.formats import bup20 as bup20_j
from pagnerf_tpu_torch import cli
from pagnerf_tpu_torch.config import config as config_t
from pagnerf_tpu_torch.config import factory as factory_t
from pagnerf_tpu_torch.data import validate as validate_t
from pagnerf_tpu_torch.data.formats import agrobot_base as agro_t
from pagnerf_tpu_torch.data.formats import bup20 as bup20_t
from pagnerf_tpu_torch.data.formats import coco as coco_t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BEST = os.path.join(ROOT, "configs", "bup20", "best.yaml")
EXACT = ("imgs", "semantics", "instance", "semantics_pred", "instance_pred", "robot_mask")
RTOL = ("depths", "sem_conf", "inst_conf")
ATOL = ("view_matrices", "rays_origins", "rays_dirs", "base_rays_origins",
        "base_rays_dirs")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops in one thread: beside five busy test workers, torch's
    spinning intra-op threads took a 5 s tiny CLI run to 293 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(bup20_root, tmp_path_factory):  # noqa: F811
    """The fixture tree and, beside it, every other payload the loaders read."""
    from PIL import Image
    root = tmp_path_factory.mktemp("ext") / "BUP_20"
    shutil.copytree(bup20_root, root)
    seq = root / "seqA"
    rng = np.random.default_rng(3)
    for name in ("preds_unet", "preds_maskrcnn", "preds_deeplab"):
        (seq / name).mkdir()
    for p in sorted(seq.glob("*.png")):
        imap = np.zeros((H, W), np.int64)
        imap[3:7, 3:9], imap[9:11, 12:15] = 1, 2
        sem = (imap > 0).astype(np.int64)
        conf = rng.uniform(0.2, 1.0, (1, H, W)).astype(np.float32)
        with bz2.open(seq / "preds_unet" / f"{p.stem}.pkl.bz2", "wb") as f:
            pickle.dump({"sem_seg": {"preds": torch.from_numpy(sem),
                                     "confidence": torch.from_numpy(conf)},
                         "instances": {"imap": torch.from_numpy(imap)}}, f)
        masks = np.zeros((2, 1, H, W), np.float32)
        masks[0, 0, 3:7, 3:9] = rng.uniform(0.4, 1.0, (4, 6))
        masks[1, 0, 9:11, 12:15] = rng.uniform(0.4, 1.0, (2, 3))
        with open(seq / "preds_maskrcnn" / f"{p.stem}.pkl", "wb") as f:
            pickle.dump({"masks": masks}, f)
        with open(seq / "preds_deeplab" / f"{p.stem}.pkl", "wb") as f:
            pickle.dump({"panoptic": np.stack([sem, imap])[None]}, f)
    # an RLE annotation in each encoding and a second category by supercategory
    with open(root / "BUP_20.json") as f:
        coco = json.load(f)
    blob = np.zeros((H, W), np.uint8)
    blob[8:11, 10:15] = 1
    blob[9, 9] = 1
    coco["categories"].append({"id": 2, "name": "red", "supercategory": "pepper"})
    center_id = CENTER + 1
    coco["annotations"] += [
        {"id": 2, "image_id": center_id, "category_id": 2, "iscrowd": 0,
         "segmentation": coco_t.encode_rle(blob)},
        {"id": 3, "image_id": center_id, "category_id": 1, "iscrowd": 0,
         "segmentation": {"size": [H, W], "counts": coco_t.mask_to_runs(blob[::-1])}}]
    with open(root / "BUP_20.json", "w") as f:
        json.dump(coco, f)
    # a palette robot mask
    robot = np.zeros((H, W), np.uint8)
    robot[:2, :5] = 1
    img = Image.fromarray(robot, "P")
    img.putpalette([0, 0, 0, 255, 255, 255] + [0] * 762)
    img.save(root / "robot_mask_p.png")
    # a PLY mesh beside the tree sets the scale and the offset
    with open(root.parent / "mesh.ply", "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\n"
                "property float y\nproperty float z\nend_header\n"
                "-0.5 -0.25 0.1\n0.7 0.3 0.9\n0.2 0.1 0.4\n")
    return root


def assert_data_equal(dt, dj):
    assert sorted(dt) == sorted(dj)
    for k in sorted(dj):
        a, b = dj[k], dt[k]
        if k in EXACT:
            assert b.dtype == a.dtype and b.shape == a.shape, k
            np.testing.assert_array_equal(b, a, err_msg=k)
        elif k in RTOL:
            assert b.dtype == a.dtype and b.shape == a.shape, k
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=k)
        elif k in ATOL:
            assert b.dtype == a.dtype, k
            np.testing.assert_allclose(b.reshape(np.shape(a)), a, rtol=0, atol=1e-6,
                                       err_msg=k)
        elif k == "intrinsics":
            assert vars(b) == vars(a)
        elif k in ("cameras_ts", "train_idxs", "val_idxs"):
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            assert b == a, k


LOAD_CASES = {
    "window": dict(dataset_center_idx=0),
    "gt_only": dict(load_modes=["imgs", "semantics", "instance"]),
    "depth_filter": dict(max_depth=1.2),
    "robot_mask": dict(robot_mask_path="robot_mask.png"),
    "robot_mask_palette": dict(robot_mask_path="robot_mask_p.png"),
    "mip1": dict(mip=1, max_depth=1.2),
    "mip2_metashape": dict(mip=2, pose_src="metashape"),
    "pose_noise": dict(add_noise_to_train_poses=True, pose_noise_strength=0.05),
    "unet": dict(load_modes=["imgs", "preds_unet"], max_depth=1.2),
    "maskrcnn": dict(load_modes=["imgs", "preds_maskrcnn"]),
    "deeplab": dict(load_modes=["imgs", "preds_deeplab"], max_depth=1.2),
    "inference": dict(mode="inference"),
    "scale_offset": dict(scale=0.5, offset=[0.1, 0.2, -1.0]),
}


@pytest.mark.parametrize("case", list(LOAD_CASES))
def test_load_data_matches_jax(tree, case):
    kw = LOAD_CASES[case]
    assert_data_equal(bup20_t.load_data(tree, **kw), bup20_j.load_data(tree, **kw))


def test_load_data_uses_the_ply_mesh(tree):
    s_t, o_t = bup20_t.load_scale_and_offset(tree)
    assert (s_t, o_t) == bup20_j.load_scale_and_offset(tree)
    assert s_t != 1.0                    # the mesh, not the defaults


@pytest.mark.parametrize("payload", ["preds_mask2former", "preds_unet", "preds_maskrcnn",
                                     "preds_deeplab"])
@pytest.mark.parametrize("cls, kw", [
    ("BUP20SequenceDataset", dict(subset="val", max_depth=1.2)),
    ("BUP20SequenceDataset", dict(subset="train")),
    ("BUP20InferenceDataset", dict(subset="val", num_rm_frames=10)),
    ("BUP20InferenceDataset", dict(subset="val", odom_src="metashape")),
], ids=["val", "train", "inference", "inference_npz"])
def test_window_frames_match_jax(tree, cls, kw, payload):
    ds_t = getattr(agro_t, cls)(tree / "BUP_20.json", preds_rel_path=payload, **kw)
    ds_j = getattr(agro_j, cls)(tree / "BUP_20.json", preds_rel_path=payload, **kw)
    assert len(ds_t) == len(ds_j)
    for i in range(len(ds_j)):
        ft, fj = ds_t[i], ds_j[i]
        assert len(ft) == len(fj)
        for a, b in zip(fj, ft):
            assert sorted(a) == sorted(b)
            for k in a:
                if isinstance(a[k], np.ndarray):
                    assert b[k].dtype == a[k].dtype, k
                    np.testing.assert_array_equal(b[k], a[k], err_msg=k)
                else:
                    assert b[k] == a[k], k


def test_centre_labels_from_polygons_and_rle(tree):
    ds = agro_t.BUP20SequenceDataset(tree / "BUP_20.json", subset="val")
    centre = [f for f in ds[0] if f["file_names"] == f"{1000 + CENTER}.png"][0]
    assert sorted(np.unique(centre["imap"]).tolist()) == [0, 1, 2, 3]
    assert (centre["semantics"] == 1).sum() == (centre["imap"] > 0).sum()


# ------------------------------------------------------------------ validator
def _copy(root, tmp_path, name):
    dst = tmp_path / name / "BUP_20"
    shutil.copytree(root, dst)
    return dst


def _break_odometry(r):
    lines = (r / "seqA" / "odometry.csv").read_text().splitlines()
    (r / "seqA" / "odometry.csv").write_text("\n".join(lines[:-3]) + "\n")


def _break_depth(r):
    sorted((r / "seqA" / "depth").iterdir())[5].unlink()


def _break_preds(r):
    sorted((r / "seqA" / "preds_mask2former").iterdir())[5].unlink()


def _break_params(r):
    (r / "seqA" / "params.yaml").write_text(
        "intrinsics: [[1.0, 0.0], [0.0, 1.0]]\nextrinsics: oops\n")


def _break_payload(r):
    with open(sorted((r / "seqA" / "preds_mask2former").iterdir())[42], "wb") as f:
        pickle.dump({"unexpected": 1}, f)


def _break_image(r):
    (r / "seqA" / f"{1000 + NUM_FRAMES // 2}.png").write_bytes(b"not a png")


BREAKS = {
    "clean": (None, {}), "clean_deep": (None, dict(deep=True)),
    "gt_only": (None, dict(load_modes=["imgs", "semantics", "instance"])),
    "metashape": (None, dict(pose_src="metashape")),
    "robot_mask": (None, dict(robot_mask_path="robot_mask.png")),
    "odometry": (_break_odometry, {}), "depth": (_break_depth, {}),
    "preds": (_break_preds, {}), "params": (_break_params, {}),
    "class_labels": (None, dict(class_labels=["bg", "tomato"])),
    "payload": (_break_payload, dict(deep=True)),
    "robot_mask_missing": (None, dict(robot_mask_path="nope.png")),
    "unet_missing": (None, dict(load_modes=["imgs", "preds_unet_other"])),
}


@pytest.mark.parametrize("case", list(BREAKS))
def test_validator_matches_jax(bup20_root, tmp_path, case):  # noqa: F811
    brk, kw = BREAKS[case]
    root = bup20_root
    if brk is not None:
        root = _copy(bup20_root, tmp_path, case)
        brk(root)
    got = validate_t.validate_bup20_tree(root, **kw)
    assert got == validate_j.validate_bup20_tree(root, **kw)
    assert bool([s for s, _ in got if s == "ERROR"]) == (case not in (
        "clean", "clean_deep", "gt_only", "metashape", "robot_mask"))


def test_validator_reports_an_unreadable_frame(bup20_root, tmp_path):  # noqa: F811
    root = _copy(bup20_root, tmp_path, "image")
    _break_image(root)
    got = validate_t.validate_bup20_tree(root)
    want = validate_j.validate_bup20_tree(root)
    # the message quotes the reader (the port's PNG reader, PIL in the JAX package)
    assert [(s, m.split(": ")[0]) for s, m in got] == [(s, m.split(": ")[0]) for s, m in want]
    assert [s for s, _ in got] == ["ERROR"]


def test_nerf_validator_matches_jax(tmp_path):
    (tmp_path / "a.png").write_bytes(b"")
    frames = [{"file_path": "a", "transform_matrix": np.eye(4).tolist()},
              {"file_path": "missing", "transform_matrix": np.eye(4).tolist()},
              {"transform_matrix": np.eye(4).tolist()}]
    (tmp_path / "transforms_train.json").write_text(json.dumps({"frames": frames}))
    got = validate_t.validate_nerf_standard_tree(tmp_path)
    assert got == validate_j.validate_nerf_standard_tree(tmp_path)
    assert len(got) == 4
    assert validate_t.validate_nerf_standard_tree(tmp_path / "nope") == \
        validate_j.validate_nerf_standard_tree(tmp_path / "nope")


@pytest.mark.parametrize("brk", [None, _break_depth, _break_params], ids=["clean", "depth",
                                                                        "params"])
def test_cli_validate_dataset_returns_the_error_count(bup20_root, tmp_path, capsys, brk):  # noqa: F811
    root = bup20_root
    if brk is not None:
        root = _copy(bup20_root, tmp_path, "cli")
        brk(root)
    argv = ["--config", BEST, "--dataset-path", str(root), "--validate-dataset"]
    ret = cli.main(argv)          # no --device: validation touches no device
    out = capsys.readouterr().out
    want = validate_j.run_validation(config_j.parse_options(argv))
    assert out == capsys.readouterr().out
    assert ret == want == sum(1 for line in out.splitlines() if line.startswith("ERROR: "))
    assert (ret == 0) == (brk is None)
    assert f"validate-dataset: {ret} error(s)" in out


# ------------------------------------------------------------------ factory
def _namespaces(root, *extra):
    argv = ["--config", BEST, "--dataset-path", str(root), *extra]
    return config_t.parse_options(argv), config_j.parse_options(argv)


@pytest.fixture(scope="module")
def dataset_pair(tree):
    args_t, args_j = _namespaces(tree, "--dataset-center-idx", "0")
    return factory_t.load_dataset(args_t), factory_j.load_dataset(args_j)


def test_factory_dataset_matches_jax(dataset_pair):
    ds_t, ds_j = dataset_pair
    assert_data_equal(ds_t.data, ds_j.data)
    np.testing.assert_array_equal(ds_t.train_idxs, ds_j.train_idxs)
    np.testing.assert_array_equal(ds_t.val_idxs, ds_j.val_idxs)
    assert ds_t.semantic_info == ds_j.semantic_info


def test_factory_batches_match_jax(dataset_pair, monkeypatch):
    ds_t, ds_j = dataset_pair
    monkeypatch.setattr(native_j, "_load", lambda: None)    # the numpy sampler
    for seed, (batch, rays) in enumerate(((6, 64), (2, 500), (4, W * H))):
        bt = ds_t.sample_batch(np.random.default_rng(seed), batch, rays)
        bj = ds_j.sample_batch(np.random.default_rng(seed), batch, rays)
        assert sorted(bt) == sorted(bj)
        for k in bj:
            np.testing.assert_array_equal(np.asarray(bt[k]), np.asarray(bj[k]), err_msg=k)


@pytest.mark.parametrize("mip", [0, 1, 2])
def test_factory_get_images_matches_jax(dataset_pair, mip):
    ds_t, ds_j = dataset_pair
    out_t, out_j = ds_t.get_images("val", mip), ds_j.get_images("val", mip)
    assert list(out_t) == list(out_j)
    for k, a in out_j.items():
        b = out_t[k]
        assert b.shape == a.shape and b.dtype == a.dtype, k
        if k in ds_j._NEAREST_MODES or k == "cam_idx":
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6, err_msg=k)


def test_factory_standard_format_matches_jax(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(0)
    frames = []
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (H, W, 4)).astype(np.uint8), "RGBA").save(
            tmp_path / f"r_{i}.png")
        c2w = np.eye(4)
        c2w[0, 3] = 0.1 * i
        frames.append({"file_path": f"r_{i}", "transform_matrix": c2w.tolist()})
    (tmp_path / "transforms_train.json").write_text(
        json.dumps({"camera_angle_x": 0.8, "frames": frames}))
    args_t, args_j = _namespaces(tmp_path, "--multiview-dataset-format", "standard",
                                 "--mip", "1")
    ds_t, ds_j = factory_t.load_dataset(args_t), factory_j.load_dataset(args_j)
    assert_data_equal(ds_t.data, ds_j.data)


def test_factory_refuses_an_unknown_format(tree):
    args_t, _ = _namespaces(tree, "--multiview-dataset-format", "replica")
    with pytest.raises(NotImplementedError, match="dataset format 'replica'"):
        factory_t.load_dataset(args_t)


def test_cli_trains_best_yaml_over_the_fixture(tree, tmp_path):
    tiny = ["--device", "cpu", "--num-lods", "4", "--capacity-log-2", "8",
            "--delta-capacity-log-2", "8", "--hidden-dim", "16", "--sem-hidden-dim", "16",
            "--inst-hidden-dim", "16", "--num-steps", "16", "--num-rays-sampled-per-img",
            "16", "--batch-size", "4", "--epochs", "1", "--render-batch", "64",
            "--dataset-center-idx", "0", "--val-mip", "2"]
    metrics = cli.main(["--config", BEST, "--dataset-path", str(tree), "--log-dir",
                        str(tmp_path)] + tiny)
    (run,) = glob.glob(os.path.join(str(tmp_path), "*", "*", ""))
    state = torch.load(os.path.join(run, "model.ckpt"), weights_only=True)
    ds = agro_t.BUP20SequenceDataset(tree / "BUP_20.json", subset="train")
    assert state["epoch"] == 1 and state["global_step"] == int(np.ceil(len(ds[0]) / 4))
    assert np.isfinite(metrics["val/psnr"])
    assert os.path.basename(os.path.dirname(os.path.dirname(run))) == "test_frame_5"


def test_window_loader_reads_no_library(tree, monkeypatch):
    """The port's loaders never reach PIL, cv2 or PyYAML."""
    import builtins
    real = builtins.__import__

    def guard(name, *args, **kwargs):
        if name.split(".")[0] in ("PIL", "cv2", "yaml"):
            raise ImportError(f"{name} is not on the card's machine")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", guard)
    data = bup20_t.load_data(tree, max_depth=1.2, robot_mask_path="robot_mask.png")
    assert data["imgs"].shape[1:] == (H, W, 3)
    assert validate_t.validate_bup20_tree(tree, deep=True) is not None
