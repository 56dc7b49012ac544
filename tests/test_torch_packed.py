"""The packed sample layout (``ops/packed.py``) and the packed and compacted
traces against the JAX package's, on the CPU. Mirrors ``tests/test_packed.py``.

- Segment ops: ``segment_sum`` and ``segment_broadcast`` (value and VJP,
  padding-tail cotangents dropped) against JAX's, atol 1e-6; the segment
  sum's telescoped backward over runs of empty segments equal to the index
  backward's;
  ``_water_fill_cap`` exactly; the compensated prefix at a flagship-size
  buffer (B = 2,097,152) against float64 sums, with the JAX test's bounds
  (weights within 5e-6, alpha rtol 3e-5 / atol 3e-6, segment sums 2e-4).
- ``pack_samples``: ``ray_id``, ``step_id``, ``offsets`` and ``valid``
  exactly equal to JAX's on adversarial masks (empty runs, all empty, all
  valid, water-fill truncation), depths, deltas and positions within 1e-6.
- ``packed_integration_weights`` against JAX's, atol 1e-6.
- The tiny flagship's packed trace (voxel march, an occupancy with empty
  space, budgets that do and do not truncate) against the JAX package's
  ``_trace_block_packed``, its march's values computed op by op
  (``test_torch_schedule.op_by_op_march``: XLA's fused arithmetic would put
  samples near a cell face on the other side), same jitter: every channel
  within 1e-5, and the gradients of a loss of all channels to the tables
  and decoders at rtol 1e-4 / atol 1e-6 of each tensor's largest entry
  (float32 decoders), to the extrinsics within 1e-3 of the largest entry
  (a sum over all samples of terms of both signs, which XLA's program and
  torch round apart; chip_smoke.py's bound). The same for
  the compacted trace. The packed trace of the port against its own dense
  trace under the same jitter when the budget covers every valid sample.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from test_torch_schedule import op_by_op_march

from pagnerf_tpu.core.rays import Rays as RaysJ
from pagnerf_tpu.models import tracer as tracer_j
from pagnerf_tpu.ops import packed as packed_j
from pagnerf_tpu.ops.occupancy import OccupancyGrid as OccJ
from pagnerf_tpu.ops.raymarch import RaymarchResult as RaymarchResultJ
from pagnerf_tpu_torch import entry as entry_t
from pagnerf_tpu_torch.convert import params_from_flax
from pagnerf_tpu_torch.core.rays import Rays
from pagnerf_tpu_torch.ops import packed as packed_t
from pagnerf_tpu_torch.ops.occupancy import OccupancyGrid
from pagnerf_tpu_torch.ops.raymarch import RaymarchResult

ALL_CH = frozenset({"rgb", "depth", "semantics", "inst_embedding"})


def _offsets(keep):
    return np.concatenate([[0], np.cumsum(keep)]).astype(np.int32)


def test_segment_sum_matches_jax():
    off = _offsets([3, 0, 2, 4])                       # an empty segment
    x = np.random.default_rng(0).normal(size=(2, 12)).astype(np.float32)
    x[:, 9:] = 1e6                                     # the padding tail
    got = packed_t.segment_sum(torch.from_numpy(x), torch.from_numpy(off)).numpy()
    want = np.asarray(packed_j.segment_sum(jnp.asarray(x), jnp.asarray(off)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[:, 1].tolist() == [0.0, 0.0]
    np.testing.assert_allclose(got[:, 3], x[:, 5:9].sum(-1), rtol=1e-6)


@pytest.mark.parametrize("keep", [[3, 0, 2, 4], [0, 0, 3, 0, 0, 1, 0], [0, 0, 0],
                                  [2, 0, 0, 5, 0, 0]])
def test_segment_sum_vjp_over_repeated_boundaries(keep):
    """Empty segments repeat a boundary: the backward's telescoped value at
    each run equals the index backward's sum, exactly on integer-valued
    cotangents in float64 and within 1e-6 of JAX's VJP in float32."""
    off = _offsets(keep)
    b = int(off[-1]) + 2                               # and a padding tail
    rng = np.random.default_rng(len(keep))
    x = rng.normal(size=(2, b)).astype(np.float32)
    g = rng.integers(-8, 9, size=(2, len(keep))).astype(np.float32)
    off_t = torch.from_numpy(off)
    hi = torch.from_numpy(x).double().requires_grad_()
    packed_t._BoundaryDiff.apply(hi, off_t).backward(torch.from_numpy(g).double())
    ref = torch.from_numpy(x).double().requires_grad_()
    (ref[:, off_t[1:].long()] - ref[:, off_t[:-1].long()]).backward(
        torch.from_numpy(g).double())
    assert torch.equal(hi.grad, ref.grad)
    xt = torch.from_numpy(x).requires_grad_()
    packed_t.segment_sum(xt, off_t).backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda v: packed_j.segment_sum(v, jnp.asarray(off)), jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=0, atol=1e-6)


def test_segment_broadcast_value_and_vjp_match_jax():
    off = _offsets([2, 3, 0, 1])
    ray_id = np.array([0, 0, 1, 1, 1, 3, 0, 0], np.int32)      # 2 padding slots
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 4)).astype(np.float32)
    g = rng.normal(size=(3, 8)).astype(np.float32)             # tail cotangents too
    xt = torch.from_numpy(x).requires_grad_()
    out = packed_t.segment_broadcast(xt, torch.from_numpy(ray_id), torch.from_numpy(off))
    out.backward(torch.from_numpy(g))
    fj = lambda v: packed_j.segment_broadcast(v, jnp.asarray(ray_id), jnp.asarray(off))
    want, vjp = jax.vjp(fj, jnp.asarray(x))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=0, atol=1e-6)
    # the padding tail's cotangents are dropped, not credited to ray 0
    np.testing.assert_allclose(xt.grad.numpy()[:, 0], g[:, :2].sum(-1), rtol=1e-6)


@pytest.mark.parametrize("budget", [0, 5, 9, 12, 17, 40])
def test_water_fill_cap_matches_jax(budget):
    counts = np.array([5, 1, 3, 8], np.int32)
    got = int(packed_t._water_fill_cap(torch.from_numpy(counts), 8, budget))
    assert got == int(packed_j._water_fill_cap(jnp.asarray(counts), 8, budget))
    assert np.minimum(counts, got).sum() <= budget
    assert got == 8 or np.minimum(counts, got + 1).sum() > budget


def test_comp_prefix_accuracy_at_flagship_buffer():
    rng = np.random.default_rng(7)
    r_count, seg = 16384, 128                          # B = 2,097,152
    b = r_count * seg
    tau32 = rng.uniform(0.0, 0.12, size=b).astype(np.float32)
    offsets = torch.arange(0, b + 1, seg, dtype=torch.int32)
    ps = packed_t.PackedSamples(
        ray_id=torch.repeat_interleave(torch.arange(r_count, dtype=torch.int32), seg),
        step_id=torch.zeros(b, dtype=torch.int32), offsets=offsets,
        valid=torch.ones(b, dtype=torch.bool), depths=torch.zeros(b),
        deltas=torch.zeros(b), positionsT=torch.zeros((3, 1)))
    w, a = packed_t.packed_integration_weights(torch.from_numpy(tau32), ps)
    tau64 = tau32.astype(np.float64).reshape(r_count, seg)
    excl64 = np.cumsum(tau64, axis=1) - tau64
    w64 = np.exp(-excl64) * (1.0 - np.exp(-tau64))
    err = np.abs(w.numpy().astype(np.float64).reshape(r_count, seg) - w64)
    assert err.max() < 5e-6, err.max()
    np.testing.assert_allclose(a.numpy()[:, 0], w64.sum(axis=1), rtol=3e-5, atol=3e-6)
    x = rng.uniform(-1.0, 1.0, size=(1, b)).astype(np.float32)
    s = packed_t.segment_sum(torch.from_numpy(x), offsets).numpy()[0]
    np.testing.assert_allclose(s, x.astype(np.float64).reshape(r_count, seg).sum(1),
                               atol=2e-4)


def _masks(r=13, s=24):
    rng = np.random.default_rng(7)
    m = rng.random((r, s)) < 0.5
    m[0] = m[1] = m[5] = m[r - 1] = False             # empty runs and edges
    return {"random": rng.random((r, s)) < 0.3, "empty": np.zeros((r, s), bool),
            "full": np.ones((r, s), bool), "empty_runs": m}


@pytest.mark.parametrize("case", list(_masks()))
def test_pack_samples_buffers_match_jax(case):
    mask = _masks()[case]
    r, s = mask.shape
    rng = np.random.default_rng(11)
    depths = (np.cumsum(rng.random((r, s)), -1) * 0.05).astype(np.float32)
    t0 = depths[:, 0].copy()
    span = (depths[:, -1] - t0 + 1e-3).astype(np.float32)
    deltas = np.full((r, s), 0.05, np.float32)
    oT, dT = (rng.random((3, r)).astype(np.float32) for _ in range(2))
    rm_j = RaymarchResultJ(positionsT=None, depths=jnp.asarray(depths),
                           deltas=jnp.asarray(deltas), mask=jnp.asarray(mask),
                           t0=jnp.asarray(t0), span=jnp.asarray(span))
    rm_t = RaymarchResult(positionsT=None, depths=torch.from_numpy(depths),
                          deltas=torch.from_numpy(deltas), mask=torch.from_numpy(mask),
                          t0=torch.from_numpy(t0), span=torch.from_numpy(span))
    for budget in (int(mask.sum()) + 4, max(4, int(mask.sum()) // 2)):
        pj = packed_j.pack_samples(rm_j, jnp.asarray(oT), jnp.asarray(dT), budget=budget)
        pt = packed_t.pack_samples(rm_t, torch.from_numpy(oT), torch.from_numpy(dT),
                                   budget=budget)
        for f in ("ray_id", "step_id", "offsets", "valid"):
            got, want = getattr(pt, f).numpy(), np.asarray(getattr(pj, f))
            assert got.dtype == want.dtype and np.array_equal(got, want), (budget, f)
        for f in ("depths", "deltas", "positionsT"):
            np.testing.assert_allclose(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)),
                                       rtol=0, atol=1e-6, err_msg=f"{budget} {f}")


def test_packed_integration_weights_match_jax():
    mask = _masks()["empty_runs"]
    r, s = mask.shape
    counts = mask.sum(-1)
    off = _offsets(counts)
    b = int(off[-1]) + 5
    ray_id = np.zeros(b, np.int32)
    ray_id[:off[-1]] = np.repeat(np.arange(r), counts)
    valid = np.arange(b) < off[-1]
    tau = np.random.default_rng(3).uniform(0, 1.5, b).astype(np.float32)
    zeros = np.zeros(b, np.float32)
    pj = packed_j.PackedSamples(ray_id=jnp.asarray(ray_id), step_id=jnp.asarray(ray_id),
                                offsets=jnp.asarray(off), valid=jnp.asarray(valid),
                                depths=jnp.asarray(zeros), deltas=jnp.asarray(zeros),
                                positionsT=jnp.zeros((3, b)))
    pt = packed_t.PackedSamples(ray_id=torch.from_numpy(ray_id),
                                step_id=torch.from_numpy(ray_id),
                                offsets=torch.from_numpy(off), valid=torch.from_numpy(valid),
                                depths=torch.zeros(b), deltas=torch.zeros(b),
                                positionsT=torch.zeros((3, b)))
    wj, aj = packed_j.packed_integration_weights(jnp.asarray(tau), pj)
    wt, at = packed_t.packed_integration_weights(torch.from_numpy(tau), pt)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=0, atol=1e-6)
    assert at.shape == (r, 1) and not wt[~torch.from_numpy(valid)].any()


# ----------------------------------------------------------------- traces
RAYS, STEPS = 48, 16


def _scene():
    """The tiny flagship on both sides (float32 decoders, converted
    parameters), one camera's rays, an occupancy with empty space, the JAX
    key's jitter."""
    pipe_j, ds_j = graft._flagship(tiny=True)
    pipe_j.nef = pipe_j.nef.clone(compute_dtype_name="float32")
    params = pipe_j.init(jax.random.PRNGKey(0))
    pipe_t, _ = entry_t.flagship(tiny=True, device="cpu", compute_dtype=torch.float32)
    pipe_t.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    pipe_t.requires_grad_(True)
    batch = ds_j.sample_batch(np.random.default_rng(2), 4, RAYS)
    m = int(np.nonzero(batch["cam_idx"] != 0)[0][0])          # not the anchor frame
    o, d = batch["base_rays_origins"][m:m + 1], batch["base_rays_dirs"][m:m + 1]
    cam = batch["cam_idx"][m:m + 1]
    c = (np.arange(8) + 0.5) / 4 - 1
    gx, gy, gz = np.meshgrid(c, c, c, indexing="ij")
    mask = ((gx ** 2 + gy ** 2 + gz ** 2) < 0.5).reshape(-1)  # a ball of cells
    key = jax.random.PRNGKey(5)
    return dict(pipe_j=pipe_j, params=params, pipe_t=pipe_t, o=o, d=d, cam=cam,
                occ_j=OccJ.create(level=3).replace(mask=jnp.asarray(mask)),
                occ_t=OccupancyGrid(occupancy=torch.zeros(512), mask=torch.from_numpy(mask),
                                    level=3),
                key=key, jitter=np.array(jax.random.uniform(key, (RAYS, STEPS))))


def _loss_j(sc, cfg):
    def loss(p):
        rb = sc["pipe_j"](p, RaysJ(origins=jnp.asarray(sc["o"]), dirs=jnp.asarray(sc["d"]),
                                   dist_min=jnp.float32(0.0), dist_max=jnp.float32(6.0)),
                          ALL_CH, sc["occ_j"], stage="train", key=sc["key"],
                          cam_idx=jnp.asarray(sc["cam"]), tracer_cfg=cfg)
        out = {ch: getattr(rb, ch) for ch in ("rgb", "depth", "alpha", "semantics",
                                               "inst_embedding", "panoptic_alpha")}
        return sum(jnp.sum(v ** 2) for v in out.values()), out
    return loss


def _run_t(sc, cfg, jitter=None):
    pipe = sc["pipe_t"]
    pipe.zero_grad(set_to_none=True)
    rb = pipe(Rays(origins=torch.from_numpy(sc["o"]), dirs=torch.from_numpy(sc["d"]),
                   dist_min=0.0, dist_max=6.0), ALL_CH, sc["occ_t"], stage="train",
              cam_idx=torch.from_numpy(sc["cam"]).long(),
              jitter=torch.from_numpy(sc["jitter"]) if jitter is None else jitter,
              tracer_cfg=cfg)
    out = {ch: getattr(rb, ch) for ch in ("rgb", "depth", "alpha", "semantics",
                                           "inst_embedding", "panoptic_alpha")}
    sum(torch.sum(v ** 2) for v in out.values()).backward()
    grads = {n: p.grad.clone() for n, p in pipe.named_parameters() if p.grad is not None}
    return {k: v.detach() for k, v in out.items()}, grads


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.mark.parametrize("layout", ["packed_covers", "packed_truncates", "compacted"])
def test_trace_matches_jax_with_gradients(scene, layout, monkeypatch):
    sc = scene
    base = dataclasses.replace(sc["pipe_t"].tracer_cfg, raymarch_type="voxel",
                               num_steps=STEPS)
    cfg = dataclasses.replace(base, **{"packed_covers": dict(pack_steps=STEPS),
                                       "packed_truncates": dict(pack_steps=4),
                                       "compacted": dict(compact_steps=6)}[layout])
    cfg_j = dataclasses.replace(sc["pipe_j"].tracer_cfg, **dataclasses.asdict(cfg))
    monkeypatch.setattr(tracer_j, "raymarch", op_by_op_march(tracer_j.raymarch))
    (_, out_j), g_j = jax.jit(jax.value_and_grad(_loss_j(sc, cfg_j), has_aux=True))(
        sc["params"])
    out_t, g_t = _run_t(sc, cfg)
    for ch, v in out_j.items():
        np.testing.assert_allclose(out_t[ch].numpy(), np.asarray(v), rtol=0, atol=1e-5,
                                   err_msg=ch)
    g_j = params_from_flax(jax.tree_util.tree_map(np.asarray, g_j))
    for name, want in g_j.items():
        got = g_t.get(name, torch.zeros_like(want))
        if name == "extrinsics":
            # the pose gradient sums all samples' contributions, of both
            # signs, through the lattice; XLA's program rounds the terms apart
            err = float((got - want).abs().max())
            assert err <= 1e-3 * float(want.abs().max()), (name, err)
            continue
        atol = 1e-6 * max(1.0, float(want.abs().max()))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=atol,
                                   err_msg=name)
    assert float(g_t["extrinsics"].abs().max()) > 0


def test_packed_trace_matches_dense_when_budget_covers(scene):
    sc = scene
    dense = dataclasses.replace(sc["pipe_t"].tracer_cfg, raymarch_type="voxel",
                                num_steps=STEPS)
    out_d, g_d = _run_t(sc, dense)
    out_p, g_p = _run_t(sc, dataclasses.replace(dense, pack_steps=STEPS))
    for ch in out_d:
        np.testing.assert_allclose(out_p[ch].numpy(), out_d[ch].numpy(), rtol=0,
                                   atol=1e-5, err_msg=ch)
    for name in g_d:
        atol = 1e-6 * max(1.0, float(g_d[name].abs().max()))
        np.testing.assert_allclose(g_p[name].numpy(), g_d[name].numpy(), rtol=1e-4,
                                   atol=atol, err_msg=name)
