"""The two-stage voxel probe (``PAGNERF_WINDOWED_PROBE=1``) of
``pagnerf_tpu_torch/ops/raymarch.py`` against the JAX package's
``raymarch`` with the same switch set, on the CPU: occupancy levels 5 and
7 with a finite ``ray_max_travel``, sparse random masks so that some rays
cross an occupied mip cell without meeting a fine one, and rays that miss
the cube. Masks exact; depths, t0 and span within 1e-5 as
``test_torch_train.py::test_raymarch_jitter_matches_jax_key`` holds them
(the JAX march runs op by op, outside ``jit``). Then the gate's off cases
(switch off, level 4, infinite travel, a window no cheaper than the
single-stage probe) equal the single-stage march bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pagnerf_tpu.core.rays import Rays as RaysJ
from pagnerf_tpu.ops.occupancy import OccupancyGrid as OccJ
from pagnerf_tpu.ops.raymarch import raymarch as raymarch_j
from pagnerf_tpu_torch.core.rays import Rays
from pagnerf_tpu_torch.ops import raymarch as rm_t
from pagnerf_tpu_torch.ops.occupancy import OccupancyGrid

N_RAYS, STEPS = 96, 24


def _rays(seed: int):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.8, 1.8, (N_RAYS, 3)).astype(np.float32)
    # most rays aim through the cube; the last 16 point away from it
    target = rng.uniform(-0.7, 0.7, (N_RAYS, 3)).astype(np.float32)
    d = target - o
    d[-16:] = o[-16:] * np.float32(1.0)
    o[-16:] = np.sign(o[-16:]) * np.maximum(np.abs(o[-16:]), 1.2)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def _mask(level: int, seed: int, share: float) -> np.ndarray:
    res = 1 << level
    rng = np.random.default_rng(seed)
    return rng.uniform(size=res ** 3) < share


def _both(level, mask, o, d, travel, jitter):
    occ_j = OccJ(occupancy=jnp.zeros((mask.size,), jnp.float32), mask=jnp.asarray(mask),
                 level=level)
    occ_t = OccupancyGrid(occupancy=torch.zeros(mask.size), mask=torch.from_numpy(mask),
                          level=level)
    key = jax.random.PRNGKey(3)
    ref = raymarch_j(RaysJ(origins=jnp.asarray(o), dirs=jnp.asarray(d),
                           dist_min=jnp.float32(0.0), dist_max=jnp.float32(6.0)),
                     occ_j, STEPS, "voxel", travel, key=key if jitter else None)
    j = torch.from_numpy(np.array(jax.random.uniform(key, (o.shape[0], STEPS)))) \
        if jitter else None
    got = rm_t.raymarch(Rays(origins=torch.from_numpy(o), dirs=torch.from_numpy(d),
                             dist_min=0.0, dist_max=6.0), occ_t, STEPS, "voxel", j, travel)
    return got, ref, occ_t


def _assert_close(got, ref):
    assert np.array_equal(got.mask.numpy(), np.asarray(ref.mask))
    for name in ("depths", "t0", "span"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(got.positionsT.numpy(), np.asarray(ref.positionsT),
                               rtol=0, atol=1e-5)


def _coarse_without_fine(occ, o, d, travel):
    """Rays whose mip probes hit and whose window probes do not."""
    rays = Rays(origins=torch.from_numpy(o), dirs=torch.from_numpy(d), dist_min=0.0,
                dist_max=6.0)
    t_near, t_far, _ = rm_t.aabb_intersect(rays)
    t0 = torch.clamp(t_near, min=0.0)
    t1 = torch.maximum(torch.minimum(t_far, torch.tensor(6.0)), t0)
    _, pn1, pn2, w_max = rm_t._window_plan(occ, travel)
    at = lambda dep: rays.origins.T[:, :, None] + rays.dirs.T[:, :, None] * dep[None]
    d1, _ = rm_t._uniform_samples(t0, t1, pn1)
    o1 = rm_t.mip_mask(occ).occupied_at_T(at(d1))
    tc = torch.amin(torch.where(o1, d1, rm_t._BIG), dim=-1)
    coarse = tc < rm_t._BIG
    tc = torch.where(coarse, torch.maximum(tc - (t1 - t0) / pn1, t0), t0)
    w = torch.clamp(t1 - tc, max=w_max)
    d2, _ = rm_t._uniform_samples(tc, tc + w, pn2)
    fine = occ.occupied_at_T(at(d2)).any(-1)
    return coarse & ~fine, ~coarse


@pytest.mark.parametrize("jitter", [False, True], ids=["midpoints", "jitter"])
@pytest.mark.parametrize("level,share", [(5, 0.002), (5, 0.02), (7, 0.0002), (7, 0.003)])
def test_windowed_probe_matches_jax(monkeypatch, level, share, jitter):
    monkeypatch.setenv("PAGNERF_WINDOWED_PROBE", "1")
    o, d = _rays(level)
    mask = _mask(level, 10 + level, share)
    got, ref, occ = _both(level, mask, o, d, 2.0, jitter)
    assert rm_t._window_plan(occ, 2.0) is not None
    _assert_close(got, ref)
    no_fine, miss = _coarse_without_fine(occ, o, d, 2.0)
    if share < 0.01:
        assert no_fine.any(), "no ray crosses a mip hit without a fine one"
    assert not got.mask[-16:].any()               # the rays pointing away
    # those rays keep their unrefit interval
    single = rm_t.raymarch(Rays(origins=torch.from_numpy(o), dirs=torch.from_numpy(d),
                                dist_min=0.0, dist_max=6.0), occ, STEPS, "ray")
    keep = no_fine | miss
    np.testing.assert_array_equal(got.t0[keep].numpy(), single.t0[keep].numpy())
    np.testing.assert_array_equal(got.span[keep].numpy(), single.span[keep].numpy())
    # and the rays that hit are refit otherwise than by the single-stage probe
    monkeypatch.setenv("PAGNERF_WINDOWED_PROBE", "0")
    off = rm_t.raymarch(Rays(origins=torch.from_numpy(o), dirs=torch.from_numpy(d),
                             dist_min=0.0, dist_max=6.0), occ, STEPS, "voxel", None, 2.0)
    assert not torch.equal(off.t0, got.t0)


@pytest.mark.parametrize("case", ["switch_off", "switch_other_value", "level_4",
                                  "infinite_travel", "window_not_cheaper"])
def test_gate_off_cases_are_the_single_stage_probe(monkeypatch, case):
    level, travel, env = 5, 2.0, "1"
    if case == "switch_off":
        env = None
    elif case == "switch_other_value":
        env = "true"                       # only "1" turns it on, as in JAX
    elif case == "level_4":
        level = 4
    elif case == "infinite_travel":
        travel = float("inf")
    else:
        travel = 10.0                      # pn1 + pn2 = 14 + 168 >= 56
    o, d = _rays(level)
    mask = _mask(level, 3, 0.01)
    if env is None:
        monkeypatch.delenv("PAGNERF_WINDOWED_PROBE", raising=False)
    else:
        monkeypatch.setenv("PAGNERF_WINDOWED_PROBE", env)
    got, ref, occ = _both(level, mask, o, d, travel, False)
    assert rm_t._window_plan(occ, travel) is None
    _assert_close(got, ref)
    monkeypatch.delenv("PAGNERF_WINDOWED_PROBE", raising=False)
    base = rm_t.raymarch(Rays(origins=torch.from_numpy(o), dirs=torch.from_numpy(d),
                              dist_min=0.0, dist_max=6.0), occ, STEPS, "voxel", None, travel)
    for name in ("depths", "mask", "t0", "span", "positionsT"):
        assert torch.equal(getattr(got, name), getattr(base, name)), name


def test_mip_mask_is_the_max_pool():
    rng = np.random.default_rng(0)
    mask = rng.uniform(size=32 ** 3) < 0.01
    occ = OccupancyGrid(occupancy=torch.zeros(mask.size), mask=torch.from_numpy(mask),
                        level=5)
    mip = rm_t.mip_mask(occ)
    assert mip.level == 3 and mip.mask.shape == (512,)
    ref = torch.nn.functional.max_pool3d(
        torch.from_numpy(mask).float().reshape(1, 1, 32, 32, 32), 4).reshape(-1) > 0
    assert torch.equal(mip.mask, ref)
