"""Module parity at tiny shapes, float32 unless stated: occupancy, raymarch,
compositing, embedder, decoders and the panoptic NeFs against the JAX
modules, with weights carried over by ``params_from_flax``. Tolerances are
float32 rounding of reordered sums and transcendental implementations."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pagnerf_tpu.core.rays import Rays as RaysJ
from pagnerf_tpu.models import decoder as dec_j
from pagnerf_tpu.models import nefs as nefs_j
from pagnerf_tpu.models.embedders import positional_embed_T as embed_j
from pagnerf_tpu.ops import composite as comp_j
from pagnerf_tpu.ops import raymarch as rm_j
from pagnerf_tpu.ops.occupancy import OccupancyGrid as OccJ
from pagnerf_tpu_torch.convert import params_from_flax
from pagnerf_tpu_torch.core.rays import Rays as RaysT
from pagnerf_tpu_torch.models import decoder as dec_t
from pagnerf_tpu_torch.models import nefs as nefs_t
from pagnerf_tpu_torch.models.embedders import positional_embed_T as embed_t
from pagnerf_tpu_torch.ops import composite as comp_t
from pagnerf_tpu_torch.ops import raymarch as rm_t
from pagnerf_tpu_torch.ops.occupancy import OccupancyGrid as OccT


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rays(n=64, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = (-o + rng.normal(0, 0.5, (n, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[0] = [0.0, 0.0, -1.0]                       # axis-aligned: 1e-9 guard
    return o, d


def test_occupancy_lookup_matches_jax():
    rng = np.random.default_rng(0)
    coords = rng.uniform(-1.2, 1.2, (3, 5000)).astype(np.float32)
    mask = rng.uniform(size=(8 ** 3,)) < 0.5
    gj = OccJ.create(level=3).replace(mask=jnp.asarray(mask))
    gt = OccT.create(level=3)
    gt.mask = torch.from_numpy(mask)
    np.testing.assert_array_equal(np.asarray(gj.cell_indices_T(jnp.asarray(coords))),
                                  gt.cell_indices_T(torch.from_numpy(coords)).numpy())
    np.testing.assert_array_equal(np.asarray(gj.occupied_at_T(jnp.asarray(coords))),
                                  gt.occupied_at_T(torch.from_numpy(coords)).numpy())
    full = OccT.create(level=7)
    assert full.mask.shape == (128 ** 3,) and bool(full.mask.all())


def test_raymarch_matches_jax():
    o, d = _rays()
    mask = np.random.default_rng(1).uniform(size=(16 ** 3,)) < 0.7
    rj = rm_j.raymarch(RaysJ(origins=jnp.asarray(o), dirs=jnp.asarray(d),
                             dist_min=jnp.float32(0.0), dist_max=jnp.float32(6.0)),
                       OccJ.create(level=4).replace(mask=jnp.asarray(mask)), 24)
    occ = OccT.create(level=4)
    occ.mask = torch.from_numpy(mask)
    rt = rm_t.raymarch(RaysT(origins=torch.from_numpy(o), dirs=torch.from_numpy(d),
                             dist_min=0.0, dist_max=6.0), occ, 24)
    for name in ("positionsT", "depths", "deltas", "t0", "span"):
        np.testing.assert_allclose(getattr(rt, name).numpy(),
                                   np.asarray(getattr(rj, name)),
                                   rtol=0, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(rt.mask.numpy(), np.asarray(rj.mask))
    assert rt.mask.any() and not rt.mask.all()


def test_raymarch_refuses_unported_modes():
    # 'voxel' is ported since (tests/test_torch_prune.py); a mode the JAX
    # package does not have is refused
    o, d = _rays(4)
    with pytest.raises(ValueError):
        rm_t.raymarch(RaysT(torch.from_numpy(o), torch.from_numpy(d), 0.0, 6.0),
                      OccT.create(level=3), 8, raymarch_type="octree")


def test_composite_matches_jax():
    rng = np.random.default_rng(2)
    tau = rng.uniform(0, 0.5, (32, 20)).astype(np.float32)
    mask = rng.uniform(size=(32, 20)) < 0.8
    feats = rng.normal(size=(5, 32, 20)).astype(np.float32)
    wj, aj = comp_j.exponential_integration_weights(jnp.asarray(tau), jnp.asarray(mask))
    wt, at = comp_t.exponential_integration_weights(torch.from_numpy(tau),
                                                    torch.from_numpy(mask))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        comp_t.composite_channel_T(torch.from_numpy(feats), wt).numpy(),
        np.asarray(comp_j.composite_channel_T(jnp.asarray(feats), wj)),
        rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        comp_t.composite_scalar(torch.from_numpy(tau), wt).numpy(),
        np.asarray(comp_j.composite_scalar(jnp.asarray(tau), wj)),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("multires", [4, 10])
def test_positional_embed_matches_jax(multires):
    x = np.random.default_rng(3).uniform(-1, 1, (3, 257)).astype(np.float32)
    np.testing.assert_allclose(embed_t(torch.from_numpy(x), multires).numpy(),
                               np.asarray(embed_j(jnp.asarray(x), multires)),
                               rtol=0, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_basic_decoder_matches_jax(dtype):
    # bf16: XLA's dot_general and torch's matmul round at different points;
    # outputs of size ~1 agree to a few bf16 ulp (2^-8 each)
    tol = 1e-5 if dtype == "float32" else 3e-2
    x = np.random.default_rng(4).normal(size=(48, 300)).astype(np.float32)
    dj = dec_j.BasicDecoder(output_dim=16, hidden_dim=64, num_layers=2,
                            output_bias_init=(1.0,),
                            compute_dtype=getattr(jnp, dtype))
    params = dj.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    dt = dec_t.BasicDecoder(48, 16, 64, 2, output_bias_init=(1.0,),
                            compute_dtype=getattr(torch, dtype))
    dt.load_state_dict(params_from_flax(_np_tree(params)))
    out = dt(torch.from_numpy(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(dj.apply({"params": params}, jnp.asarray(x))),
                               rtol=0, atol=tol)


def test_decoder_seeded_init_distribution():
    d = dec_t.BasicDecoder(48, 16, 64, 1, output_bias_init=(1.0,))
    d.reset_parameters(torch.Generator().manual_seed(0))
    k = d.hidden_0.kernel.detach()
    std = (1.0 / 48) ** 0.5 / 0.87962566103423978
    assert float(k.abs().max()) <= 2 * std + 1e-6
    assert abs(float(k.std()) - (1.0 / 48) ** 0.5) < 0.02
    b = d.lout.bias.detach()
    assert float(b[0]) == 1.0 and float(b[1:].abs().max()) == 0.0


GRID_J = nefs_j.GridConfig(grid_type="PermutoGrid", num_lods=4, feature_dim=2,
                           capacity_log2=8, coarsest_scale=1.0, finest_scale=0.05)
GRID_T = nefs_t.GridConfig(num_lods=4, feature_dim=2, capacity_log2=8,
                           coarsest_scale=1.0, finest_scale=0.05)
NEF_KW = dict(num_classes=3, num_instances=5, hidden_dim=32)


@pytest.mark.parametrize("variant", [
    ("PanopticDeltaNeF", dict(panoptic_features_type="delta")),
    ("PanopticDeltaNeF", dict(panoptic_features_type="delta",
                              fuse_dual_grid=False)),
    ("PanopticDeltaNeF", dict(panoptic_features_type="separate",
                              inst_sigmoid=True, inst_normalize=True,
                              inst_soft_temperature=0.5)),
    ("PanopticNeF", dict(sem_sigmoid=True, multiscale_type="sum")),
], ids=["delta_fused", "delta_unfused", "separate_inst_chain", "base_sum"])
@pytest.mark.parametrize("channels", [
    frozenset({"density", "rgb", "semantics", "inst_embedding"}),
    frozenset({"density", "rgb"})], ids=["panoptic", "rgb"])
def test_nef_matches_jax(variant, channels):
    cls, kw = variant
    rng = np.random.default_rng(5)
    coords = rng.uniform(-1, 1, (3, 500)).astype(np.float32)
    dirs = rng.normal(size=(3, 500)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=0, keepdims=True)
    nj = getattr(nefs_j, cls)(grid=GRID_J, **NEF_KW, **kw)
    params = nj.init(jax.random.PRNGKey(1), jnp.asarray(coords), jnp.asarray(dirs),
                     nj.supported_channels())["params"]
    # non-trivial tables so the features matter
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.asarray(rng.uniform(-1, 1, v.shape), v.dtype)
        if "tables" in jax.tree_util.keystr(p) else v, params)
    nt = getattr(nefs_t, cls)(grid=GRID_T, **NEF_KW, **kw)
    nt.load_state_dict(params_from_flax(_np_tree(params)))
    lod_w = rng.uniform(0.5, 1.0, (GRID_J.output_dim,)).astype(np.float32)
    oj = nj.apply({"params": params}, jnp.asarray(coords), jnp.asarray(dirs),
                  channels, jnp.asarray(lod_w))
    with torch.no_grad():
        ot = nt(torch.from_numpy(coords), torch.from_numpy(dirs), channels,
                torch.from_numpy(lod_w))
    assert sorted(ot) == sorted(oj) == sorted(channels)
    for ch in channels:
        np.testing.assert_allclose(ot[ch].numpy(), np.asarray(oj[ch]),
                                   rtol=0, atol=1e-5, err_msg=ch)
