"""Each training branch that this slice ports, one tiny step against the JAX
trainer, on the CPU: the tiny flagship (4 LoDs x 2^8, 16 steps, 2 images of
32 rays, one per microbatch) with float32 decoders, the NeF, tracer and
trainer settings of each case, the same converted parameters, the same
numpy batch, the same stratified jitter (the uniforms the JAX step drew
from its keys, per block of rays under ``ray_chunk``) and the same TV
windows (the normals JAX drew):

- ``dd_panoptic``: ``PanopticDDensityNeF`` under the DD tracer, the
  panoptic stage with the things loss;
- ``sup_contrastive``: ``MeanShiftPanopticDeltaNeF`` with raw normalised
  embeddings (``mean_shift_contrastive.yaml``'s head) and the contrastive
  instance loss;
- ``linear_assignment``: the plain linear-assignment instance loss;
- ``contrast_sem``: ``contrast_sem_weight > 0``;
- ``grid_tv``: the grid and delta-grid TV terms, L1 and L2;
- ``ray_sparsity_ray_chunk`` / ``ray_sparsity_sample_chunk``:
  ``ray_sparsity_reg > 0`` with ``ray_chunk`` (32 rays in blocks of 20, the
  last padded) and with ``sample_chunk``. In blocks of 12 a pre-activation
  of the instance head lies at 2.3e-10, inside the float32 rounding of its
  inputs, so the ReLU's derivative there differs between the packages (one
  bias entry of 58 moves by 0.066): a kink of the function, not a fault. The JAX trainer cannot take both
  at once: its jitted step fails to trace the nested checkpointed scans
  (``TypeError: A ShapeDtypeStruct does not have a value``); the port runs
  them together (``tests/test_torch_dd.py`` holds that trace to JAX's
  unjitted one).

Each microbatch's gradients (JAX's ``grad_step`` against the port's) at
rtol 1e-4 with an atol of 1e-6 of the tensor's largest entry (at least of
1). The atol is 1e-5 of it for the chunked cases, whose blocks' gradients
add in another order than JAX's scan; for the contrastive case, whose 1 /
0.07 temperature scales the similarities' float32 rounding 14-fold before
the exponential; and for the TV case, whose L1 gradient is the sign of each
neighbour difference: a difference within a float32 rounding of 0 may take
the other sign (one such flip moves a delta-table entry by ~7e-5 here);
the step's averaged losses at atol 1e-5 (``total_loss``
also rtol 1e-6)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from pagnerf_tpu.models import clustering_nef as cnef_j
from pagnerf_tpu.models import nefs as nefs_j
from pagnerf_tpu.train.optimizer import OptimizerConfig as OptJ
from pagnerf_tpu.train.trainer import PanopticTrainer as TrainerJ
from pagnerf_tpu.train.trainer import TrainerConfig as CfgJ
from pagnerf_tpu_torch import entry as entry_t
from pagnerf_tpu_torch.convert import params_from_flax
from pagnerf_tpu_torch.models import clustering_nef as cnef_t
from pagnerf_tpu_torch.models import nefs as nefs_t
from pagnerf_tpu_torch.models.pipeline import BAPipeline
from pagnerf_tpu_torch.train.optimizer import OptimizerConfig
from pagnerf_tpu_torch.train.trainer import PanopticTrainer

torch.set_num_threads(1)
RAYS = 32


def _cls(modules, name):
    return next(getattr(m, name) for m in modules if hasattr(m, name))


def trainer_pair(cls="PanopticDeltaNeF", nef_kw=None, tracer_kw=None, occ_level=7,
                 **cfg_changes):
    """The JAX and the port trainer of the tiny flagship with the NeF
    ``cls`` (float32 decoders, ``nef_kw`` on top), the tracer settings
    ``tracer_kw`` and the panoptic ``train_config`` with ``cfg_changes``, on
    the JAX trainer's initial parameters."""
    nef_kw, tracer_kw = nef_kw or {}, tracer_kw or {}
    cfg = dataclasses.replace(entry_t.train_config("panoptic", tiny=True), **cfg_changes)
    pipe_j, ds_j = graft._flagship(tiny=True)
    fields = {f.name: getattr(pipe_j.nef, f.name) for f in dataclasses.fields(pipe_j.nef)
              if f.init and f.name not in ("parent", "name")}
    pipe_j.nef = _cls((nefs_j, cnef_j), cls)(**dict(fields, compute_dtype_name="float32",
                                                     **nef_kw))
    pipe_j.tracer_cfg = dataclasses.replace(pipe_j.tracer_cfg, **tracer_kw)
    tj = TrainerJ(pipe_j, ds_j, CfgJ(**dataclasses.asdict(cfg)), OptJ(), occ_level=occ_level)

    base, ds_t = entry_t.flagship(tiny=True, device="cpu", compute_dtype=torch.float32)
    si = ds_t.semantic_info
    nef = _cls((nefs_t, cnef_t), cls)(
        grid=base.nef.grid_cfg, num_classes=si["num_classes"],
        num_instances=si["num_instances"], hidden_dim=64, panoptic_features_type="delta",
        compute_dtype=torch.float32, **nef_kw)
    pipe_t = BAPipeline(nef, dataclasses.replace(base.tracer_cfg, **tracer_kw),
                        torch.from_numpy(ds_t.data["view_matrices"]), anchor_frame_idxs=[0])
    pipe_t.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, tj.params)))
    pipe_t.requires_grad_(True)
    tt = PanopticTrainer(pipe_t, ds_t, cfg, OptimizerConfig(), occ_level=occ_level)
    return tj, tt


def _split(batch, m):
    b = batch["imgs"].shape[0]
    return {k: v[m:m + 1] if getattr(v, "ndim", 0) >= 1 and v.shape[0] == b else v
            for k, v in batch.items()}


def _draws(tj, k):
    """The uniforms and TV normals that JAX's microbatch key ``k`` gives."""
    tcfg, cfg, steps = tj.pipeline.tracer_cfg, tj.cfg, tj.pipeline.tracer_cfg.num_steps
    if 0 < tcfg.ray_chunk < RAYS:
        nb = -(-RAYS // tcfg.ray_chunk)
        jitter = np.concatenate([np.asarray(jax.random.uniform(kb, (tcfg.ray_chunk, steps)))
                                 for kb in jax.random.split(k, nb)])
    else:
        jitter = np.asarray(jax.random.uniform(k, (RAYS, steps)))
    normals, key = [], k
    if cfg.grid_tvl1_reg > 0 or cfg.grid_tvl2_reg > 0:
        k1, key = jax.random.split(key)
        normals.append(np.asarray(jax.random.normal(k1, (3,))))
    if cfg.delta_grid_tvl1_reg > 0 or cfg.delta_grid_tvl2_reg > 0:
        k2, key = jax.random.split(key)
        normals.append(np.asarray(jax.random.normal(k2, (3,))))
    return jitter, normals


def step_pair(tj, tt, epoch=0):
    """One step of both trainers at ``epoch``; returns the stages, both
    steps' losses and each microbatch's gradients."""
    stage_j, stage_t = tj.stage_for_epoch(epoch), tt.stage_for_epoch(epoch)
    batch = tj.dataset.sample_batch(np.random.default_rng(0), tt.cfg.batch_size, RAYS)
    params0, key = tj.params, tj._step_key
    losses_j = {k: float(v) for k, v in tj.train_step(stage_j, batch).items()}
    grad_step = tj._train_step_cache[stage_j][0]
    micro = []
    for m in range(batch["imgs"].shape[0]):
        key, k = jax.random.split(key)
        sub = _split(batch, m)
        g, _ = grad_step(params0, tj.occ, tj.lod_w,
                         {kk: jnp.asarray(v) for kk, v in sub.items()}, k)
        micro.append((sub, *_draws(tj, k),
                      params_from_flax(jax.tree_util.tree_map(np.asarray, g))))
    normals = [torch.from_numpy(n.copy()) for _, _, ns, _ in micro for n in ns]
    queue = normals + normals          # the grad steps, then the train step
    tt.draw_normal = lambda shape: queue.pop(0)
    grads_t = [tt.grad_step(stage_t, sub, jitter=torch.from_numpy(jit.copy()))[0]
               for sub, jit, _, _ in micro]
    losses_t = tt.train_step(stage_t, batch,
                             jitters=[torch.from_numpy(j.copy()) for _, j, _, _ in micro])
    assert not queue
    return dict(stage_j=stage_j, stage_t=stage_t, losses_j=losses_j,
                losses_t={k: float(v) for k, v in losses_t.items()},
                grads_j=[g for *_, g in micro], grads_t=grads_t)


CASES = {
    "dd_panoptic": dict(cls="PanopticDDensityNeF",
                        tracer_kw=dict(tracer_type="PanopticDDensityPackedRFTracer")),
    "sup_contrastive": dict(cls="MeanShiftPanopticDeltaNeF",
                            nef_kw=dict(inst_softmax=False, inst_normalize=True),
                            inst_loss="sup_contrastive", inst_weight=1.0),
    "linear_assignment": dict(inst_loss="linear_assignment"),
    "contrast_sem": dict(contrast_sem_weight=0.5),
    "grid_tv": dict(grid_tvl1_reg=1e-3, grid_tvl2_reg=2e-3, delta_grid_tvl1_reg=3e-3,
                    delta_grid_tvl2_reg=4e-3, tv_edge_num_samples=10, tv_window_size=0.3),
    "ray_sparsity_ray_chunk": dict(tracer_kw=dict(ray_sparsity_reg=0.01, ray_chunk=20)),
    "ray_sparsity_sample_chunk": dict(tracer_kw=dict(ray_sparsity_reg=0.01,
                                                     sample_chunk=100)),
}
# a loss each case adds to the step's losses
EXTRA_LOSS = {"ray_sparsity_ray_chunk": "ray_sparsity_loss",
              "ray_sparsity_sample_chunk": "ray_sparsity_loss",
              "contrast_sem": "contrast_sem_loss"}
# the cases whose gradients take an atol of 1e-5 of the largest entry
LOOSER_ATOL = ("ray_sparsity_ray_chunk", "ray_sparsity_sample_chunk", "sup_contrastive",
               "grid_tv")


@pytest.fixture(scope="module", params=list(CASES))
def run(request):
    tj, tt = trainer_pair(**CASES[request.param])
    return dict(step_pair(tj, tt), case=request.param)


def test_stage_matches_jax(run):
    assert dataclasses.asdict(run["stage_t"]) == dataclasses.asdict(run["stage_j"])
    assert run["stage_t"].use_inst and run["stage_t"].use_sem


def test_step_losses_match_jax(run):
    lj, lt = run["losses_j"], run["losses_t"]
    assert sorted(lt) == sorted(lj)
    assert EXTRA_LOSS.get(run["case"], "inst_loss") in lt
    for k in lj:
        assert np.isfinite(lt[k])
        rtol = 1e-6 if k == "total_loss" else 0.0
        np.testing.assert_allclose(lt[k], lj[k], rtol=rtol, atol=1e-5, err_msg=k)


def test_gradients_match_jax(run):
    atol_rel = 1e-5 if run["case"] in LOOSER_ATOL else 1e-6
    for gj, gt in zip(run["grads_j"], run["grads_t"]):
        assert sorted(gt) == sorted(gj)
        for name in gj:
            want, got = gj[name].numpy(), gt[name].numpy()
            atol = atol_rel * max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol,
                                       err_msg=f"{run['case']}: {name}")
    if run["case"] == "dd_panoptic":
        assert any(np.any(g["nef.decoder_delta_density.lout.kernel"].numpy())
                   for g in run["grads_t"])
