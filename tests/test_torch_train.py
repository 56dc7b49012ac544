"""The training slice end to end at tiny shapes, against the JAX
``PanopticTrainer`` of ``__graft_entry__._flagship(tiny=True)``, on the CPU.

One step of each stage -- RGB (``TrainerConfig()`` at epoch 0), panoptic at
epoch 0 and at epoch 2 (segment regulariser on) -- from the same converted
parameters, the same numpy batch and the same stratified jitter (the port
gets the uniforms the JAX step drew from its keys):

- each microbatch's gradients (the JAX trainer's own ``grad_step`` against
  the port's ``grad_step``), every parameter, extrinsics included: float32
  decoders at rtol 1e-4 / atol 1e-6, the atol scaled by the tensor's largest
  entry where that exceeds 1: the panoptic heads' gradients carry the
  instance loss's weight of 1000 (entries up to ~1e2), and an entry whose
  events cancel keeps the float32 rounding of its large terms;
- the step's averaged losses (``train_step`` on both sides): atol 1e-5, and
  rtol 1e-6 for ``total_loss``, which weighs the instance loss by 1000 so
  its float32 ulp is ~5e-4;
- bfloat16 decoders (the flagship setting), panoptic at epoch 2: losses at
  rtol 1e-4 and each gradient within 2e-2 of its tensor's largest entry,
  because XLA and torch round the bfloat16 matmuls' products and sums at
  different points; each difference is one bfloat16 ulp (2^-8 relative) of
  an activation or a cotangent, and a gradient sums many of them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from pagnerf_tpu.core.rays import Rays as RaysJ
from pagnerf_tpu.data import native as native_j
from pagnerf_tpu.ops.occupancy import OccupancyGrid as OccJ
from pagnerf_tpu.ops.raymarch import raymarch as raymarch_j
from pagnerf_tpu.train.optimizer import OptimizerConfig as OptJ
from pagnerf_tpu.train.trainer import PanopticTrainer as TrainerJ
from pagnerf_tpu.train.trainer import TrainerConfig as CfgJ
from pagnerf_tpu_torch import entry as entry_t
from pagnerf_tpu_torch.convert import params_from_flax
from pagnerf_tpu_torch.core.rays import Rays
from pagnerf_tpu_torch.data.multiview import MultiviewDataset
from pagnerf_tpu_torch.data.synthetic import make_dataset
from pagnerf_tpu_torch.ops.occupancy import OccupancyGrid
from pagnerf_tpu_torch.ops.raymarch import raymarch
from pagnerf_tpu_torch.train.optimizer import OptimizerConfig
from pagnerf_tpu_torch.train.trainer import PanopticTrainer, TrainerConfig

RAYS, STEPS = 32, 16
CASES = {"rgb_epoch0": ("rgb", 0, "float32"),
         "panoptic_epoch0": ("panoptic", 0, "float32"),
         "panoptic_epoch2": ("panoptic", 2, "float32"),
         "panoptic_epoch2_bf16": ("panoptic", 2, "bfloat16")}


def _split(batch, m):
    b = batch["imgs"].shape[0]
    return {k: v[m:m + 1] if getattr(v, "ndim", 0) >= 1 and v.shape[0] == b else v
            for k, v in batch.items()}


@pytest.fixture(scope="module", params=list(CASES))
def run(request):
    """Both trainers through one step of one case; returns what they gave."""
    stage_name, epoch, dtype = CASES[request.param]
    cfg_t = entry_t.train_config(stage_name, tiny=True)
    pipe_j, ds_j = graft._flagship(tiny=True)
    pipe_j.nef = pipe_j.nef.clone(compute_dtype_name=dtype)
    tj = TrainerJ(pipe_j, ds_j, CfgJ(**dataclasses.asdict(cfg_t)), OptJ())
    stage_j = tj.stage_for_epoch(epoch)
    batch = ds_j.sample_batch(np.random.default_rng(0), cfg_t.batch_size, RAYS)
    params0, key = tj.params, tj._step_key
    losses_j = {k: float(v) for k, v in tj.train_step(stage_j, batch).items()}
    grad_step = tj._train_step_cache[stage_j][0]
    micro = []
    for m in range(batch["imgs"].shape[0]):
        key, k = jax.random.split(key)
        sub = _split(batch, m)
        g, _ = grad_step(params0, tj.occ, tj.lod_w,
                         {kk: jnp.asarray(v) for kk, v in sub.items()}, k)
        jitter = np.array(jax.random.uniform(k, (RAYS, STEPS)))
        micro.append((sub, jitter, params_from_flax(
            jax.tree_util.tree_map(np.asarray, g))))

    pipe_t, ds_t = entry_t.flagship(tiny=True, device="cpu",
                                    compute_dtype=getattr(torch, dtype))
    pipe_t.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params0)))
    pipe_t.requires_grad_(True)
    tt = PanopticTrainer(pipe_t, ds_t, cfg_t, OptimizerConfig())
    stage_t = tt.stage_for_epoch(epoch)
    grads_t = [tt.grad_step(stage_t, sub, jitter=torch.from_numpy(jit))[0]
               for sub, jit, _ in micro]
    losses_t = tt.train_step(stage_t, batch, jitters=[torch.from_numpy(j)
                                                      for _, j, _ in micro])
    return dict(dtype=dtype, stage_j=stage_j, stage_t=stage_t, batch=batch,
                losses_j=losses_j, losses_t={k: float(v) for k, v in losses_t.items()},
                grads_j=[g for _, _, g in micro], grads_t=grads_t)


def test_stage_matches_jax(run):
    assert dataclasses.asdict(run["stage_t"]) == dataclasses.asdict(run["stage_j"])


def test_step_losses_match_jax(run):
    lj, lt = run["losses_j"], run["losses_t"]
    assert sorted(lt) == sorted(lj)
    for k in lj:
        assert np.isfinite(lt[k])
        if run["dtype"] == "bfloat16":
            np.testing.assert_allclose(lt[k], lj[k], rtol=1e-4, err_msg=k)
        elif k == "total_loss":
            np.testing.assert_allclose(lt[k], lj[k], rtol=1e-6, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_allclose(lt[k], lj[k], rtol=0, atol=1e-5, err_msg=k)


def test_gradients_match_jax(run):
    assert 0 in run["batch"]["cam_idx"] and len(run["batch"]["cam_idx"]) == 2
    for gj, gt, cam in zip(run["grads_j"], run["grads_t"], run["batch"]["cam_idx"]):
        assert sorted(gt) == sorted(gj)
        for name in gj:
            want, got = gj[name].numpy(), gt[name].numpy()
            msg = f"camera {cam}: {name}"
            if run["dtype"] == "bfloat16":
                assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max(), msg
            else:
                atol = 1e-6 * max(1.0, float(np.abs(want).max()))
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol, err_msg=msg)
        # the anchor frame's pose gets no gradient; the other camera's does
        ext = gt["extrinsics"].numpy()
        assert np.all(ext[0] == 0.0)
        assert (np.abs(ext[cam]).max() > 0) == (cam != 0)


def test_stage_for_epoch_refuses_unported_parts():
    pipe, ds = entry_t.flagship(tiny=True, device="cpu")
    pipe.requires_grad_(True)
    rgb = PanopticTrainer(pipe, ds, TrainerConfig())
    rgb.stage_for_epoch(0)
    # ported since: the val-pose epoch and the voxel march after the prune,
    # LoD annealing and random LoD
    assert rgb.stage_for_epoch(10).training_val_poses
    assert rgb.stage_for_epoch(202).raymarch_type == "voxel"
    # ported since: the TV regularisers and the contrastive instance loss
    for kw in ({"lod_anneling": True}, {"random_lod": True}, {"grid_tvl1_reg": 1e-3},
               {"inst_loss": "sup_contrastive", "sem_epoch_start": 0,
                "inst_epoch_start": 0}):
        PanopticTrainer(pipe, ds, TrainerConfig(**kw)).stage_for_epoch(0)
    with pytest.raises(NotImplementedError, match="fused_micro_step"):
        PanopticTrainer(pipe, ds, TrainerConfig(fused_micro_step=True)).stage_for_epoch(0)


def _data():
    return make_dataset(num_views=4, width=16, height=16, num_spheres=2)


@pytest.mark.parametrize("rays", [300, 4096])
def test_sample_batch_with_replacement_bit_identical(rays):
    from pagnerf_tpu.data.multiview import MultiviewDataset as DatasetJ
    from pagnerf_tpu.data.synthetic import make_dataset as make_dataset_j
    bj = DatasetJ(make_dataset_j(num_views=4, width=16, height=16, num_spheres=2)) \
        .sample_batch(np.random.default_rng(3), 6, rays)
    bt = MultiviewDataset(_data()).sample_batch(np.random.default_rng(3), 6, rays)
    assert sorted(bt) == sorted(bj)
    for k in bj:
        assert bt[k].dtype == bj[k].dtype and np.array_equal(bt[k], bj[k]), k


def test_sample_batch_distinct_path_matches_numpy_fallback(monkeypatch):
    from pagnerf_tpu.data.multiview import MultiviewDataset as DatasetJ
    from pagnerf_tpu.data.synthetic import make_dataset as make_dataset_j
    monkeypatch.setattr(native_j, "_load", lambda: None)
    bj = DatasetJ(make_dataset_j(num_views=4, width=16, height=16, num_spheres=2)) \
        .sample_batch(np.random.default_rng(4), 6, 40)
    bt = MultiviewDataset(_data()).sample_batch(np.random.default_rng(4), 6, 40)
    for k in bj:
        assert np.array_equal(bt[k], bj[k]), k
    for dirs in bt["base_rays_dirs"]:           # distinct pixels per image
        assert len(np.unique(dirs, axis=0)) == 40


def test_raymarch_jitter_matches_jax_key():
    rng = np.random.default_rng(5)
    o = rng.uniform(-2, 2, (20, 3)).astype(np.float32)
    d = rng.normal(size=(20, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    key = jax.random.PRNGKey(9)
    ref = raymarch_j(RaysJ(origins=jnp.asarray(o), dirs=jnp.asarray(d),
                           dist_min=jnp.float32(0.0), dist_max=jnp.float32(6.0)),
                     OccJ.create(level=3), 8, key=key)
    jitter = torch.from_numpy(np.array(jax.random.uniform(key, (20, 8))))
    got = raymarch(Rays(origins=torch.from_numpy(o), dirs=torch.from_numpy(d),
                        dist_min=0.0, dist_max=6.0),
                   OccupancyGrid.create(level=3), 8, jitter=jitter)
    np.testing.assert_allclose(got.depths.numpy(), np.asarray(ref.depths), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got.positionsT.numpy(), np.asarray(ref.positionsT),
                               rtol=0, atol=1e-5)
    assert np.array_equal(got.mask.numpy(), np.asarray(ref.mask))
    with pytest.raises(ValueError):
        raymarch(Rays(origins=torch.from_numpy(o), dirs=torch.from_numpy(d),
                      dist_min=0.0, dist_max=6.0),
                 OccupancyGrid.create(level=3), 8, jitter=jitter[:, :4])


@pytest.mark.parametrize("stage", entry_t.TRAIN_STAGES)
def test_train_flagship_tiny_on_cpu(stage):
    trainer, log = entry_t.train_flagship(stage, steps=3, device="cpu", tiny=True)
    assert len(log) == 3 and trainer.global_step == 3
    assert [s["epoch"] for s in log] == [0, 1, 2]
    assert all(sorted(s["cam_idx"]) == [0, 2] for s in log)
    assert all(np.isfinite(v) for s in log for v in s["losses"].values())
    want = {"rgb_loss", "total_loss"} | ({"sem_loss", "inst_loss"}
                                         if stage == "panoptic" else set())
    assert set(log[0]["losses"]) == want
