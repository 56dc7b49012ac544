"""The prune, the occupancy update, the optimizer reset, the voxel march and
per-ray compaction against the JAX package, on the CPU.

- ``cell_centers_jittered_T`` given JAX's draw: bit-equal.
- ``update_from_density`` over decay, ``monotone`` and ``dilate`` in {0, 1,
  2}, from the same accumulator, mask and density: accumulator and mask
  exactly equal (the 3^3 max of a dilation is ``F.max_pool3d``).
- ``MaskedOptimizer.reset_moments``: moments zero, counts kept, as the JAX
  trainer's ``_reinit_opt_state`` leaves its state after a prune.
- ``PanopticTrainer.prune`` (real, seed with the keep floor, refresh) on the
  tiny flagship given the JAX trainer's draws, the field of
  ``test_torch_schedule.fixture_params``: the occupied share equal, the
  masks equal where the accumulators are bit-equal and elsewhere only at
  counted threshold ties (at most 1% of cells) and within the dilation
  reach of one; the seed floor repeats JAX's float64 quantile, one step
  down, and the float32 comparison.
- The voxel march (finite and infinite ``ray_max_travel``, midpoints and
  jitter) against the JAX package's, op by op: t0, span, depths and
  positions within 1e-6, mask exactly; ``compact_samples`` likewise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_schedule import JaxDraws, fixture_params

import __graft_entry__ as graft
from pagnerf_tpu.core.rays import Rays as RaysJ
from pagnerf_tpu.ops import occupancy as occ_j
from pagnerf_tpu.ops import raymarch as rm_j
from pagnerf_tpu.train.optimizer import OptimizerConfig as OptJ
from pagnerf_tpu.train.trainer import PanopticTrainer as TrainerJ
from pagnerf_tpu.train.trainer import TrainerConfig as CfgJ
from pagnerf_tpu_torch import entry as entry_t
from pagnerf_tpu_torch.convert import params_from_flax
from pagnerf_tpu_torch.core.rays import Rays
from pagnerf_tpu_torch.ops import raymarch as rm_t
from pagnerf_tpu_torch.ops.occupancy import MIN_DENSITY, OccupancyGrid
from pagnerf_tpu_torch.train.optimizer import OptimizerConfig
from pagnerf_tpu_torch.train.trainer import PanopticTrainer, TrainerConfig


def _grids(level, rng, sparse=False):
    n = (1 << level) ** 3
    occ = rng.uniform(0, 6, n).astype(np.float32)
    if sparse:
        occ *= rng.random(n) < 0.05
    mask = rng.random(n) < 0.7
    return (occ_j.OccupancyGrid(occupancy=jnp.asarray(occ), mask=jnp.asarray(mask),
                                level=level),
            OccupancyGrid(occupancy=torch.from_numpy(occ), mask=torch.from_numpy(mask),
                          level=level))


def test_cell_centers_jittered_match_jax():
    key = jax.random.PRNGKey(4)
    gj, gt = _grids(3, np.random.default_rng(0))
    want = np.asarray(gj.cell_centers_jittered_T(key))
    got = gt.cell_centers_jittered_T(torch.from_numpy(np.array(
        jax.random.uniform(key, (3, 512))))).numpy()
    assert got.shape == (3, 512) and np.array_equal(got, want)
    assert gt.cell_centers_jittered_T(torch.Generator().manual_seed(0)).shape == (3, 512)
    with pytest.raises(ValueError):
        gt.cell_centers_jittered_T(torch.zeros((3, 511)))


@pytest.mark.parametrize("dilate", [0, 1, 2])
@pytest.mark.parametrize("monotone", [False, True])
@pytest.mark.parametrize("decay", [0.6, 1.0])
def test_update_from_density_matches_jax(dilate, monotone, decay):
    rng = np.random.default_rng(dilate * 4 + monotone * 2 + int(decay))
    gj, gt = _grids(4, rng, sparse=True)
    density = rng.uniform(0, 3.1, 4096).astype(np.float32)   # ~5% over the threshold
    density[:5] = MIN_DENSITY                           # exactly at the threshold
    nj = gj.update_from_density(jnp.asarray(density), decay=decay, dilate=dilate,
                                monotone=monotone)
    nt = gt.update_from_density(torch.from_numpy(density), decay=decay, dilate=dilate,
                                monotone=monotone)
    assert np.array_equal(nt.occupancy.numpy(), np.asarray(nj.occupancy))
    assert np.array_equal(nt.mask.numpy(), np.asarray(nj.mask))
    assert nt.level == 4 and 0 < nt.mask.float().mean() < 1


def _trainer_pair(cfg, level=3):
    pipe_j, ds_j = graft._flagship(tiny=True)
    pipe_j.nef = pipe_j.nef.clone(compute_dtype_name="float32")
    tj = TrainerJ(pipe_j, ds_j, CfgJ(**dataclasses.asdict(cfg)), OptJ(), occ_level=level)
    p = fixture_params(tj.params)
    tj.params = jax.tree_util.tree_map(jnp.asarray, p)
    tj.opt_state = tj.tx.init(tj.params)
    pipe_t, ds_t = entry_t.flagship(tiny=True, device="cpu", compute_dtype=torch.float32)
    pipe_t.load_state_dict(params_from_flax(p))
    pipe_t.requires_grad_(True)
    tt = PanopticTrainer(pipe_t, ds_t, cfg, OptimizerConfig(), occ_level=level,
                         draw=JaxDraws(cfg.seed))
    return tj, tt


def _assert_prune_matches(tj, tt, dilate):
    occ_jx, occ_tx = np.asarray(tj.occ.occupancy), tt.occ.occupancy.numpy()
    mask_jx, mask_tx = np.asarray(tj.occ.mask), tt.occ.mask.numpy()
    assert tt._occ_frac == tj._occ_frac and tt._pruned
    np.testing.assert_allclose(occ_tx, occ_jx, rtol=1e-5, atol=1e-6)
    thr = np.float32(MIN_DENSITY)
    ties = (occ_tx.view(np.int32) != occ_jx.view(np.int32)) & ((occ_tx > thr) != (occ_jx > thr))
    assert ties.sum() <= 0.01 * ties.size
    res = 1 << tt.occ.level
    reach = torch.from_numpy(ties.reshape(1, 1, res, res, res).astype(np.float32))
    for _ in range(dilate):
        reach = torch.nn.functional.max_pool3d(reach, 3, 1, 1)
    assert not ((mask_tx != mask_jx) & (reach.reshape(-1).numpy() == 0)).any()


def test_prune_matches_jax():
    """The real prune of the untrained field, a step that fills the Adam
    moments, and a second prune (monotone: ANDed with the first's mask):
    moments zeroed, counts kept."""
    cfg = TrainerConfig(batch_size=6, num_rays_sampled_per_img=32, micro_batch_imgs=1,
                        prune_dilate=1)
    tj, tt = _trainer_pair(cfg)
    tj.prune()
    tt.prune()
    _assert_prune_matches(tj, tt, cfg.prune_dilate)
    assert tt._real_pruned and 0.05 < tt._occ_frac < 0.95
    batch = tj.dataset.sample_batch(np.random.default_rng(0), 6, 32)
    stage = tt.stage_for_epoch(0)
    tj.train_step(tj.stage_for_epoch(0), batch)
    tt.train_step(stage, batch, jitters=[tt.draw((32, stage.num_steps))
                                         for _ in range(batch["imgs"].shape[0])])
    assert any(v.any() for v in tt.opt.mu.values())
    tj.prune()
    tt.prune()
    _assert_prune_matches(tj, tt, cfg.prune_dilate)
    assert all(not v.any() for v in tt.opt.mu.values())
    assert all(not v.any() for v in tt.opt.nu.values())
    flat = jax.tree_util.tree_flatten_with_path(tj.opt_state)[0]
    counts = {int(leaf) for kp, leaf in flat if str(getattr(kp[-1], "name", "")) == "count"}
    assert set(tt.opt.count.values()) == counts == {1}


@pytest.mark.parametrize("refresh", [False, True])
def test_seed_prune_keep_floor_matches_jax(refresh):
    """keep_frac 0.9 is above the thresholded share, so the floor keeps the
    densest cells: a float64 quantile of the accumulator, one float64 step
    down, compared in float32. No optimizer reset."""
    cfg = TrainerConfig(batch_size=6, num_rays_sampled_per_img=32, micro_batch_imgs=1,
                        prune_dilate=0)
    tj, tt = _trainer_pair(cfg, level=4)
    tj.prune(seed=True, keep_frac=0.9, refresh=refresh)
    tt.prune(seed=True, keep_frac=0.9, refresh=refresh)
    assert tt._pruned and not tt._real_pruned
    occ = tt.occ.occupancy.numpy()
    kept = occ > np.float32(np.nextafter(np.quantile(occ.astype(np.float64), 0.1), -np.inf))
    mask = tt.occ.mask.numpy()
    assert np.array_equal(mask, kept) if refresh else (mask >= kept).all()
    _assert_prune_matches(tj, tt, 0 if refresh else 1)
    assert tt._occ_frac > 0.85


# ------------------------------------------------------------- voxel march
def _rays(n=300, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    t = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    d = t - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


@pytest.mark.parametrize("travel", [2.0, 0.5, float("inf")])
@pytest.mark.parametrize("jittered", [False, True])
def test_voxel_march_matches_jax(travel, jittered):
    o, d = _rays()
    gj, gt = _grids(4, np.random.default_rng(3))
    key = jax.random.PRNGKey(1) if jittered else None
    with jax.disable_jit():
        rj = rm_j.raymarch(RaysJ(origins=jnp.asarray(o), dirs=jnp.asarray(d),
                                 dist_min=jnp.float32(0.0), dist_max=jnp.float32(6.0)),
                           gj, 24, "voxel", travel, key=key)
    jit = (torch.from_numpy(np.array(jax.random.uniform(key, (300, 24))))
           if jittered else None)
    rt = rm_t.raymarch(Rays(origins=torch.from_numpy(o), dirs=torch.from_numpy(d),
                            dist_min=0.0, dist_max=6.0), gt, 24, "voxel", jit, travel)
    for name in ("t0", "span", "depths", "deltas", "positionsT"):
        np.testing.assert_allclose(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    assert np.array_equal(rt.mask.numpy(), np.asarray(rj.mask))
    # the refit moved the interval of the rays that hit an occupied cell
    ray_mode = rm_t.raymarch(Rays(torch.from_numpy(o), torch.from_numpy(d), 0.0, 6.0),
                             gt, 24)
    assert (rt.t0 > ray_mode.t0).any() and (rt.span <= ray_mode.span + 1e-6).all()


@pytest.mark.parametrize("keep", [0, 5, 12, 24])
def test_compact_samples_matches_jax(keep):
    o, d = _rays(64, seed=2)
    gj, gt = _grids(3, np.random.default_rng(5))
    with jax.disable_jit():
        rj = rm_j.compact_samples(rm_j.raymarch(
            RaysJ(origins=jnp.asarray(o), dirs=jnp.asarray(d), dist_min=jnp.float32(0.0),
                  dist_max=jnp.float32(6.0)), gj, 24, "voxel", 2.0), keep)
    rt = rm_t.compact_samples(rm_t.raymarch(
        Rays(torch.from_numpy(o), torch.from_numpy(d), 0.0, 6.0), gt, 24, "voxel",
        None, 2.0), keep)
    for name in ("depths", "deltas", "positionsT", "t0", "span"):
        np.testing.assert_allclose(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    assert np.array_equal(rt.mask.numpy(), np.asarray(rj.mask))
    assert rt.depths.shape[1] == (keep if 0 < keep < 24 else 24)
