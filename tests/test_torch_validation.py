"""Validation's slice of the port against the JAX package, on the CPU.

- The host modules are numpy copies: metrics, post-processing, clustering,
  colouring and ``add_synthetic_predictions`` give the JAX package's values
  exactly on the same seeded inputs; ``write_png`` decodes with PIL to the
  bytes it was given.
- ``get_images`` at mip 0, 1 and 2: images within 1e-6 of cv2's area
  filter, labels equal to cv2's nearest filter, rays within 1e-6.
- ``batch_render`` of converted tiny-flagship parameters (float32 decoders):
  dense, and packed with the chunk budget grown, against the JAX
  ``batch_render`` within rtol 3e-5, atol 3e-6 on every channel; the packed
  render never truncates (it equals the dense one).
- After a tiny schedule's state (the scene fixture's occupancy, the voxel
  march and the packed layout, val extrinsics moved as a val-pose step
  moves them, synthetic predictions): the whole ``validate`` -- every metric
  within 1e-6 of JAX's, PSNR within 1e-3 dB, the semantic and instance maps
  equal except at pixels whose top-two logits lie within 3e-5 in JAX's
  render (counted) -- and ``generate_pc_map_from_views``: the same kept
  points within 1e-5.

The JAX renders after the prune run their march op by op
(``test_torch_schedule.op_by_op_march``): XLA's fused multiply-adds move
voxel probes that lie within an ulp of a cell face into the other cell.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import __graft_entry__ as graft
from pagnerf_tpu.core.rays import Rays as RaysJ
from pagnerf_tpu.data import multiview as mv_j
from pagnerf_tpu.data import synthetic as syn_j
from pagnerf_tpu.models import tracer as tracer_j
from pagnerf_tpu.train import trainer as trainer_mod_j
from pagnerf_tpu.train import validation as val_j
from pagnerf_tpu.train.optimizer import OptimizerConfig as OptJ
from pagnerf_tpu.train.trainer import PanopticTrainer as TrainerJ
from pagnerf_tpu.train.trainer import StageConfig as StageJ
from pagnerf_tpu.train.trainer import TrainerConfig as CfgJ
from pagnerf_tpu.utils import clustering as clu_j
from pagnerf_tpu.utils import metrics as met_j
from pagnerf_tpu.utils import postprocess as post_j
from pagnerf_tpu.utils import render_map as map_j
from pagnerf_tpu.utils import visualization as vis_j
from pagnerf_tpu_torch import entry as entry_t
from pagnerf_tpu_torch.convert import params_from_flax
from pagnerf_tpu_torch.core.rays import Rays as RaysT
from pagnerf_tpu_torch.data import multiview as mv_t
from pagnerf_tpu_torch.data import synthetic as syn_t
from pagnerf_tpu_torch.train import validation as val_t
from pagnerf_tpu_torch.train.optimizer import OptimizerConfig
from pagnerf_tpu_torch.train.trainer import PanopticTrainer, StageConfig, TrainerConfig
from pagnerf_tpu_torch.utils import clustering as clu_t
from pagnerf_tpu_torch.utils import metrics as met_t
from pagnerf_tpu_torch.utils import postprocess as post_t
from pagnerf_tpu_torch.utils import render_map as map_t
from pagnerf_tpu_torch.utils import visualization as vis_t
from test_torch_schedule import fixture_params, op_by_op_march

CHANNELS = ("rgb", "depth", "semantics", "inst_embedding")


# ------------------------------------------------------------ host modules
def _label_pair(rng, n=2, h=24, w=20, classes=3, instances=5):
    """[n, 2, h, w] (category, instance) maps with blobby segments, a
    prediction and a target that mostly agree."""
    sem = rng.integers(0, classes, (n, h // 4, w // 4)).repeat(4, 1).repeat(4, 2)
    inst = rng.integers(0, instances, (n, h // 4, w // 4)).repeat(4, 1).repeat(4, 2)
    inst = np.where(sem == 0, 0, inst)
    target = np.stack([sem, inst], 1)
    pred = target.copy()
    flip = rng.random(pred.shape) < 0.1
    pred[flip] = rng.integers(0, instances, pred.shape)[flip]
    return pred, target


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_jax(seed):
    rng = np.random.default_rng(seed)
    a, b = rng.random((3, 16, 16, 3)), rng.random((3, 16, 16, 3))
    pj, pt = met_j.PSNR(), met_t.PSNR()
    for i in range(3):
        pj.update(a[i], b[i])
        pt.update(a[i], b[i])
    assert pt.compute() == pj.compute()
    pred, target = _label_pair(rng)
    ij, it = met_j.IoU(3), met_t.IoU(3)
    qj = met_j.PanopticQuality({1, 2}, {0})
    qt = met_t.PanopticQuality({1, 2}, {0})
    mj, mt = met_j.MeanAveragePrecision(), met_t.MeanAveragePrecision()
    for k in range(pred.shape[0]):
        ij.update(pred[k, 0], target[k, 0])
        it.update(pred[k, 0], target[k, 0])
        qj.update(pred[k:k + 1], target[k:k + 1])
        qt.update(pred[k:k + 1], target[k:k + 1])
        pm = pred[k, 1][None] == np.arange(1, 5)[:, None, None]
        gm = target[k, 1][None] == np.arange(1, 5)[:, None, None]
        scores = rng.random(4)
        mj.update(pm, scores, gm)
        mt.update(pm, scores, gm)
        np.testing.assert_array_equal(met_t._mask_iou(pm, gm), met_j._mask_iou(pm, gm))
    assert it.compute() == ij.compute()
    assert qt.compute() == qj.compute()
    assert mt.compute() == mj.compute()


@pytest.mark.parametrize("seed", [0, 1])
def test_postprocess_equal_jax(seed):
    rng = np.random.default_rng(seed)
    _, target = _label_pair(rng, n=1, h=40, w=36)
    inst = target[0, 1]
    masks = (inst[None] == np.arange(1, 5)[:, None, None]).astype(np.int64)
    np.testing.assert_array_equal(post_t._binary_open(masks, 2), post_j._binary_open(masks, 2))
    np.testing.assert_array_equal(post_t.center_of_mass_outlier_rejection(masks),
                                  post_j.center_of_mass_outlier_rejection(masks))
    e = rng.random((40 * 36, 6)).astype(np.float32)
    for gated in (False, True):
        for a, b in zip(post_t.decode_instance_map(e, target[0, 0], [0], gated),
                        post_j.decode_instance_map(e, target[0, 0], [0], gated)):
            np.testing.assert_array_equal(a, b)
    for kw in (dict(num_dilations=1), dict(num_dilations=0, outlier_rejection=False),
               dict(min_mask_px=10)):
        for a, b in zip(post_t.clean_instance_map(inst, **kw),
                        post_j.clean_instance_map(inst, **kw)):
            np.testing.assert_array_equal(a, b)


def test_clustering_equal_jax(monkeypatch):
    """The port always fits ``_SimpleMeanShift``: the JAX package's fallback
    when sklearn is missing (made missing here)."""
    rng = np.random.default_rng(0)
    centres = rng.normal(size=(4, 6))
    labels = rng.integers(0, 4, (3, 200))
    emb = centres[labels] + 0.05 * rng.normal(size=(3, 200, 6))
    np.testing.assert_array_equal(clu_t.mean_class_embedding(emb, labels),
                                  clu_j.mean_class_embedding(emb, labels))
    sj, st = clu_j._SimpleMeanShift().fit(centres), clu_t._SimpleMeanShift().fit(centres)
    np.testing.assert_array_equal(st.cluster_centers_, sj.cluster_centers_)
    queries = emb.reshape(-1, 6)
    np.testing.assert_array_equal(st.predict(queries), sj.predict(queries))
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    mj, mt = clu_j.MeanShift(), clu_t.MeanShift()
    np.testing.assert_array_equal(mt.predict_clusters(emb), mj.predict_clusters(emb))
    mj.train_clustering(emb, labels)
    mt.train_clustering(emb, labels)
    np.testing.assert_array_equal(mt.predict_clusters(emb), mj.predict_clusters(emb))


@pytest.mark.parametrize("kw", [
    dict(num_views=4, width=16, height=16, num_spheres=2),
    dict(num_views=8, width=64, height=48, num_spheres=4),
    dict(num_views=6, width=30, height=20, num_spheres=3, seed=5, supersample=1),
], ids=["tiny", "flagship", "seed5"])
def test_synthetic_predictions_bit_identical(kw):
    seed = kw.get("seed", 0)
    a = syn_j.add_synthetic_predictions(syn_j.make_dataset(**kw), seed=seed)
    b = syn_t.add_synthetic_predictions(syn_t.make_dataset(**kw), seed=seed)
    for k in ("semantics_pred", "instance_pred", "sem_conf", "inst_conf"):
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert a["semantic_info"] == b["semantic_info"]
    assert (a["instance_pred"] > 0).any()


def test_colouring_equal_jax():
    rng = np.random.default_rng(3)
    for n in (1, 2, 7, 300):
        np.testing.assert_array_equal(vis_t.label_colormap(n), vis_j.label_colormap(n))
    lab = rng.integers(0, 9, (12, 10))
    img = rng.random((12, 10, 3)).astype(np.float32)
    img_u8 = (img * 255).astype(np.uint8)
    for kw in (dict(), dict(colormap=vis_j.label_colormap(4)), dict(image=img),
               dict(image=img_u8, alpha=0.7)):
        np.testing.assert_array_equal(vis_t.label2rgb(lab, **kw), vis_j.label2rgb(lab, **kw))
    depth = rng.random((12, 10)) * 3
    for args in ((), (0.0, 1.0), (0.5, 2.5)):
        np.testing.assert_array_equal(vis_t.depth2rgb(depth, *args),
                                      vis_j.depth2rgb(depth, *args))


@pytest.mark.parametrize("shape", [(9, 13), (9, 13, 3), (9, 13, 4)])
def test_write_png_decodes_with_pil(tmp_path, shape):
    img = np.random.default_rng(1).integers(0, 256, shape).astype(np.uint8)
    path = tmp_path / "x.png"
    vis_t.write_png(str(path), img)
    np.testing.assert_array_equal(np.array(Image.open(path)), img)
    vis_t.write_png(str(path), img.astype(np.float32) / 255)       # a [0, 1] float image
    np.testing.assert_array_equal(np.array(Image.open(path)), img)
    vis_t.write_video(str(tmp_path / "v.mp4"), [img, img])
    assert sorted(p.name for p in tmp_path.glob("v_*.png")) == ["v_0000.png", "v_0001.png"]


@pytest.mark.parametrize("mip", [0, 1, 2])
def test_get_images_matches_jax(mip):
    kw = dict(num_views=8, width=64, height=48, num_spheres=4)
    out_j = mv_j.MultiviewDataset(
        syn_j.add_synthetic_predictions(syn_j.make_dataset(**kw))).get_images("val", mip)
    out_t = mv_t.MultiviewDataset(
        syn_t.add_synthetic_predictions(syn_t.make_dataset(**kw))).get_images("val", mip)
    assert list(out_t) == list(out_j)
    for k, a in out_j.items():
        b = out_t[k]
        assert b.shape == a.shape and b.dtype == a.dtype, k
        if k in mv_j.MultiviewDataset._NEAREST_MODES or k == "cam_idx":
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6, err_msg=k)
    assert out_t["imgs"].shape[1:3] == (48 >> mip, 64 >> mip)


# ------------------------------------------------------------- renders
def _trainer_pair(**changes):
    """The JAX and the port trainer of the tiny flagship (float32 decoders)
    on the same converted parameters, default schedule settings."""
    cfg = dataclasses.replace(TrainerConfig(batch_size=6, num_rays_sampled_per_img=32,
                                            micro_batch_imgs=1), **changes)
    pipe_j, ds_j = graft._flagship(tiny=True)
    pipe_j.nef = pipe_j.nef.clone(compute_dtype_name="float32")
    tj = TrainerJ(pipe_j, ds_j, CfgJ(**dataclasses.asdict(cfg)), OptJ(), occ_level=6)
    p = fixture_params(tj.params)
    # val cameras moved as a val-pose step moves them
    p["extrinsics"][1::2] += np.random.default_rng(4).normal(
        0, 2e-3, p["extrinsics"][1::2].shape).astype(np.float32)
    tj.params = jax.tree_util.tree_map(jnp.asarray, p)
    pipe_t, ds_t = entry_t.flagship(tiny=True, device="cpu", compute_dtype=torch.float32)
    pipe_t.load_state_dict(params_from_flax(p))
    tt = PanopticTrainer(pipe_t, ds_t, cfg, OptimizerConfig(), occ_level=6)
    return tj, tt


def _fixture_occupancy(tj, tt):
    """Both trainers past a prune: the scene fixture's occupancy."""
    entry_t.apply_scene_fixture(tt)
    tj.occ = tj.occ.__class__(occupancy=jnp.asarray(tt.occ.occupancy.numpy()),
                              mask=jnp.asarray(tt.occ.mask.numpy()), level=tj.occ.level)
    for t in (tj, tt):
        t._pruned = t._real_pruned = True
    tj._occ_frac = tt._occ_frac


@pytest.fixture
def op_by_op(monkeypatch):
    march = op_by_op_march(tracer_j.raymarch)
    monkeypatch.setattr(tracer_j, "raymarch", march)
    monkeypatch.setattr(trainer_mod_j, "raymarch", march)


def _stage(cls, pack, num_steps=24, raymarch_type="ray"):
    return cls(channels=frozenset(CHANNELS), raymarch_type=raymarch_type,
               num_steps=num_steps, compact_steps=0, pack_steps=pack, use_sem=True,
               use_inst=True, use_inst_segment_reg=False, training_val_poses=False,
               extrinsics_on=False)


def _val_rays(tt):
    imgs = tt.dataset.get_images("val", mip=0)
    o, d = imgs["base_rays_origins"].reshape(-1, 3), imgs["base_rays_dirs"].reshape(-1, 3)
    return (RaysJ(origins=jnp.asarray(o), dirs=jnp.asarray(d), dist_min=jnp.float32(0.0),
                  dist_max=jnp.float32(6.0)),
            RaysT(origins=torch.from_numpy(o), dirs=torch.from_numpy(d), dist_min=0.0,
                  dist_max=6.0), int(imgs["cam_idx"][0]))


def _assert_channels_close(rb_t, rb_j, what):
    for ch in CHANNELS:
        np.testing.assert_allclose(getattr(rb_t, ch).numpy(), np.asarray(getattr(rb_j, ch)),
                                   rtol=3e-5, atol=3e-6, err_msg=f"{what} {ch}")


def test_batch_render_matches_jax():
    """Dense and packed (budget 8 of 24 steps, grown per chunk) on the full
    grid, chunks of 96 rays (the last one short): each against JAX's."""
    tj, tt = _trainer_pair(render_batch=96)
    rays_j, rays_t, cam = _val_rays(tt)
    for pack in (0, 8):
        rb_j = tj.batch_render(rays_j, set(CHANNELS), cam_idx=cam,
                               stage_cfg=_stage(StageJ, pack))
        rb_t = tt.batch_render(rays_t, set(CHANNELS), cam_idx=cam,
                               stage_cfg=_stage(StageConfig, pack))
        _assert_channels_close(rb_t, rb_j, f"pack {pack}")
        assert [c["rays"] for c in tt.last_render] == [96, 96, 64]
        if pack:    # every ray marches the whole grid: each budget grew, to dense
            assert all(c["pack_steps"] in (0, 16) and c["valid"] > 8 * c["rays"]
                       for c in tt.last_render)


def test_packed_render_never_truncates_dense_chunks():
    """The port's counterpart of the JAX package's test of the same name:
    with a budget of 8 of 24 steps, chunks of contiguous image rays hold
    more valid samples than the budget; the packed render grows each
    chunk's buffer and equals the dense render."""
    _, tt = _trainer_pair(render_batch=64)
    _, rays, cam = _val_rays(tt)
    chans = {"rgb", "depth", "semantics"}
    dense = tt.batch_render(rays, chans, cam_idx=cam, stage_cfg=_stage(StageConfig, 0))
    packed = tt.batch_render(rays, chans, cam_idx=cam, stage_cfg=_stage(StageConfig, 8))
    assert any(c["pack_steps"] != 8 for c in tt.last_render)
    for ch in chans:
        np.testing.assert_allclose(getattr(packed, ch).numpy(), getattr(dense, ch).numpy(),
                                   rtol=3e-5, atol=3e-6, err_msg=ch)


def _capture(trainer, monkeypatch):
    """Record every ``batch_render`` result of ``trainer``."""
    seen, render = [], trainer.batch_render

    def wrapped(*args, **kwargs):
        rb = render(*args, **kwargs)
        seen.append(rb)
        return rb
    monkeypatch.setattr(trainer, "batch_render", wrapped)
    return seen


def _near_ties(x, tol=3e-5):
    """Pixels whose two largest entries lie within ``tol``."""
    top = np.sort(x, axis=-1)
    return top[:, -1] - top[:, -2] <= tol


def test_validate_after_the_schedule_matches_jax(monkeypatch, op_by_op, tmp_path):
    tj, tt = _trainer_pair(render_batch=128)
    for t in (tj, tt):
        t.dataset.data = (syn_j if t is tj else syn_t).add_synthetic_predictions(
            t.dataset.data)
    _fixture_occupancy(tj, tt)
    epoch = tt.cfg.epochs
    tj.epoch = tt.epoch = epoch
    stage = tt.stage_for_epoch(epoch - 1)
    assert stage.raymarch_type == "voxel" and stage.pack_steps > 0
    seen_j, seen_t = _capture(tj, monkeypatch), _capture(tt, monkeypatch)
    mj = val_j.validate(tj, epoch)
    mt = val_t.validate(tt, epoch, log_dir=str(tmp_path))
    assert sorted(mt) == sorted(mj)
    assert "val/pq_things_gain" in mt and "val/iou_gain" in mt and "val/map_pred" in mt
    assert len(seen_t) == len(seen_j) == 2
    stuff = tt.dataset.semantic_info["stuff_ids"]
    flips = 0
    for rb_t, rb_j in zip(seen_t, seen_j):
        _assert_channels_close(rb_t, rb_j, "validate")
        sem_j = np.asarray(rb_j.semantics)
        sem_t = rb_t.semantics.numpy()
        ties = _near_ties(sem_j)
        differ = sem_t.argmax(-1) != sem_j.argmax(-1)
        assert not (differ & ~ties).any()
        e_j, e_t = np.asarray(rb_j.inst_embedding)[:, 1:], rb_t.inst_embedding.numpy()[:, 1:]
        things = ~np.isin(sem_j.argmax(-1), stuff)
        differ_i = things & (e_t.argmax(-1) != e_j.argmax(-1))
        assert not (differ_i & ~_near_ties(e_j)).any()
        flips += int(differ.sum() + differ_i.sum())
    for k, v in mj.items():
        if k == "val/render_time_per_img":
            continue
        tol = 1e-3 if k == "val/psnr" else 1e-6
        assert abs(mt[k] - v) <= tol, (k, mt[k], v, flips)
    assert (tmp_path / "metrics.csv").exists()
    assert (tmp_path / "val" / f"epoch_{epoch}" / "0_sem.png").exists()


def test_point_cloud_map_matches_jax(op_by_op):
    tj, tt = _trainer_pair(render_batch=64)
    _fixture_occupancy(tj, tt)
    tj.epoch = tt.epoch = tt.cfg.epochs
    kw = dict(mip=1, alpha_threshold=0.5, depth_range=(0.5, 5.0))
    out_j = map_j.generate_pc_map_from_views(tj, **kw)
    out_t = map_t.generate_pc_map_from_views(tt, **kw)
    assert sorted(out_t) == sorted(out_j) == ["color", "inst_embedding", "points"]
    assert out_t["points"].shape == out_j["points"].shape and len(out_t["points"]) > 100
    for k in out_j:
        np.testing.assert_allclose(out_t[k], out_j[k], rtol=0, atol=1e-5, err_msg=k)


def test_validate_flagship_tiny_on_cpu():
    """The entry at the tiny size on the CPU: the pre-prune validation at
    the schedule's first validation epoch (rgb and depth), the final one at
    ``cfg.epochs`` with the panoptic and ``_pred`` metrics, and the map."""
    parts = []
    trainer, res = entry_t.validate_flagship(
        device="cpu", tiny=True, steps=1, after=lambda part, t: parts.append(part))
    cfg = trainer.cfg
    assert parts == list(res) == ["pre_prune", "schedule", "final", "map"]
    assert res["pre_prune"]["epoch"] == cfg.valid_every - 1 < cfg.sem_epoch_start
    assert sorted(res["pre_prune"]["metrics"]) == ["val/psnr", "val/render_time_per_img"]
    final = res["final"]["metrics"]
    assert res["final"]["epoch"] == cfg.epochs
    assert {"val/iou_gain", "val/pq_things_gain", "val/map", "val/map_pred"} <= set(final)
    assert all(np.isfinite(v) for v in final.values())
    assert [s.get("stage").training_val_poses for s in res["schedule"]["log"][1:]] == [
        False, True]
    pts = res["map"]["points"]
    assert pts["points"].shape[1] == 3 and len(pts["points"]) == len(pts["color"])
