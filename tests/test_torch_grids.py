"""The grids of this slice against the JAX package, on the CPU: the hash,
triplanar, dense and TensoRF grids, ``build_grid``'s registry, the grid
config, the TensoRF resolution steps, and the panoptic NeFs over the hash
and triplanar grids (the delta NeF over the hash grid through the fused dual
encode).

Inputs come from numpy seeds; the JAX modules' initial parameters go
through ``convert.params_from_flax`` into the port's modules. Forward
outputs at atol 1e-5 (float32 sums in other orders); gradients (the
parameters' and the coordinates') at rtol 1e-4 with an atol of 1e-6 of the
tensor's largest entry (at least of 1e-6)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pagnerf_tpu.models import grids as grids_j
from pagnerf_tpu.models import nefs as nefs_j
from pagnerf_tpu.models import tensorf as tensorf_j
from pagnerf_tpu_torch.convert import params_from_flax
from pagnerf_tpu_torch.models import grids as grids_t
from pagnerf_tpu_torch.models import nefs as nefs_t
from pagnerf_tpu_torch.models import tensorf as tensorf_t

torch.set_num_threads(1)

GRIDS = {
    "hash": (grids_j.HashGrid, grids_t.HashGrid,
             dict(num_lods=4, feature_dim=2, log2_table_size=8)),
    "triplanar": (grids_j.TriplanarGrid, grids_t.TriplanarGrid,
                  dict(num_lods=3, feature_dim=4, base_lod=2)),
    "dense": (grids_j.DenseGrid, grids_t.DenseGrid,
              dict(num_lods=3, feature_dim=4, base_lod=2)),
    "tensorf": (tensorf_j.TensoRFGrid, tensorf_t.TensoRFGrid,
                dict(density_n_comp=4, app_n_comp=6, resolution=12)),
}


def _coords(seed, n=1500):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (3, n)).astype(np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, what, atol_rel=1e-6):
    want = np.asarray(want)
    atol = atol_rel * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=atol, err_msg=what)


def _pair(name, seed=0):
    cls_j, cls_t, kw = GRIDS[name]
    mod_j = cls_j(**kw)
    x = _coords(seed)
    params = mod_j.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    if name != "tensorf":
        # random tables at a unit scale, so the sums are not all of tiny numbers
        rng = np.random.default_rng(seed + 1)
        params = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.uniform(-1, 1, p.shape).astype(np.float32)), params)
    mod_t = cls_t(**kw)
    mod_t.load_state_dict(params_from_flax(_np_tree(params)))
    return mod_j, params, mod_t, x


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", list(GRIDS))
def test_grid_forward_and_gradients_match_jax(name):
    mod_j, params, mod_t, x = _pair(name)
    w = [np.random.default_rng(9 + i).normal(size=o.shape).astype(np.float32)
         for i, o in enumerate(_outputs(mod_j.apply({"params": params}, jnp.asarray(x))))]

    def loss_j(p, xx):
        outs = _outputs(mod_j.apply({"params": p}, xx))
        return sum(jnp.sum(o * wi) for o, wi in zip(outs, w))
    outs_j = _outputs(mod_j.apply({"params": params}, jnp.asarray(x)))
    dp_j, dx_j = jax.grad(loss_j, argnums=(0, 1))(params, jnp.asarray(x))

    xx = torch.from_numpy(x).requires_grad_()
    outs_t = _outputs(mod_t(xx))
    assert len(outs_t) == len(outs_j)
    for got, want in zip(outs_t, outs_j):
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    sum(torch.sum(o * torch.from_numpy(wi)) for o, wi in zip(outs_t, w)).backward()
    grads_t = {n: p.grad for n, p in mod_t.named_parameters()}
    grads_j = params_from_flax(_np_tree(dp_j))
    assert sorted(grads_t) == sorted(grads_j)
    for n in grads_j:
        _close(grads_t[n].numpy(), grads_j[n].numpy(), f"{name}: {n}")
    _close(xx.grad.numpy(), dx_j, f"{name}: coordinates")


def test_build_grid_registry_matches_jax():
    names = ("PermutoGrid", "HashGrid", "HashGridTorch", "HashGridTinyCudaNN",
             "TriplanarGrid", "TensoRF", "OctreeGrid", "CodebookOctreeGrid", "Occtree")
    kw = dict(num_lods=2, feature_dim=2, capacity_log2=6, log2_table_size=6, base_lod=2,
              resolution=8, density_n_comp=2, app_n_comp=2, unknown_field=1)
    for name in names:
        got = grids_t.build_grid(name, **kw)
        want = grids_j.build_grid(name, **{k: v for k, v in kw.items() if k != "unknown_field"})
        assert type(got).__name__ == type(want).__name__, name
    with pytest.raises(NotImplementedError):
        grids_t.build_grid("NoSuchGrid")
    assert type(grids_t.build_grid("TensoRF", resolution=8)).__name__ == "TensoRFGrid"


def test_grid_config_matches_jax():
    fields_t = {f.name: f.default for f in dataclasses.fields(nefs_t.GridConfig)}
    fields_j = {f.name: f.default for f in dataclasses.fields(nefs_j.GridConfig)}
    assert fields_t.pop("compute_dtype") == torch.float32
    assert fields_j.pop("compute_dtype") == "float32"
    assert fields_t == fields_j
    for gt in ("PermutoGrid", "HashGrid", "TensoRF", "TriplanarGrid"):
        assert nefs_t.GridConfig(grid_type=gt, num_lods=3).output_dim == \
            nefs_j.GridConfig(grid_type=gt, num_lods=3).output_dim
    cfg = nefs_t.GridConfig(grid_type="HashGrid", num_lods=3, log2_table_size=7)
    grid = cfg.build()
    assert isinstance(grid, grids_t.HashGrid) and grid.tables.shape == (3, 128, 2)
    assert grid.output_dim == cfg.output_dim == 6


def test_grid_inits_are_seeded_and_in_the_jax_ranges():
    for name, lo, hi in (("hash", -1e-4, 1e-4), ("triplanar", 0.0, 1e-4),
                         ("dense", 0.0, 1e-4)):
        _, _, kw = GRIDS[name]
        a, b = GRIDS[name][1](**kw), GRIDS[name][1](**kw)
        a.reset_parameters(torch.Generator().manual_seed(0))
        b.reset_parameters(torch.Generator().manual_seed(0))
        for (n, pa), pb in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(pa, pb), n
            assert lo <= float(pa.detach().min()) and float(pa.detach().max()) < hi, n
    t = tensorf_t.TensoRFGrid(**GRIDS["tensorf"][2])
    t.reset_parameters(torch.Generator().manual_seed(0))
    assert abs(float(t.app_plane.std()) - 0.1) < 0.01 and t.basis_mat.bias is None


@pytest.mark.parametrize("res_target", [16, 19])
def test_tensorf_upsample_matches_jax(res_target):
    rng = np.random.default_rng(res_target)
    params = {"density_plane": rng.normal(size=(3, 4, 12, 12)).astype(np.float32),
              "density_line": rng.normal(size=(3, 4, 12)).astype(np.float32),
              "app_plane": rng.normal(size=(3, 6, 12, 12)).astype(np.float32),
              "app_line": rng.normal(size=(3, 6, 12)).astype(np.float32),
              "basis_mat": {"kernel": rng.normal(size=(18, 27)).astype(np.float32)}}
    want = tensorf_j.upsample_vm_params(jax.tree_util.tree_map(jnp.asarray, params),
                                        res_target)
    got = tensorf_t.upsample_vm_params(
        {k: torch.from_numpy(v) for k, v in params.items() if k != "basis_mat"}, res_target)
    for k in ("density_plane", "density_line", "app_plane", "app_line"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    assert tensorf_t.resolution_schedule(128, 192, 5) == \
        tensorf_j.resolution_schedule(128, 192, 5) == [128, 144, 160, 176, 192]


def _nef_pair(cls, grid_kw, seed=0, **kw):
    grid_j = nefs_j.GridConfig(**grid_kw)
    grid_t = nefs_t.GridConfig(**grid_kw)
    nef_j = getattr(nefs_j, cls)(grid=grid_j, num_classes=5, num_instances=7, hidden_dim=16,
                                 compute_dtype_name="float32", **kw)
    x = _coords(seed, n=700)
    d = np.random.default_rng(seed + 1).normal(size=(3, 700)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    chans = frozenset({"density", "rgb", "semantics", "inst_embedding"})
    params = nef_j.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(d),
                        chans)["params"]
    if grid_kw["grid_type"] != "TensoRF":
        rng = np.random.default_rng(seed + 2)
        params = dict(params)
        for g in ("grid", "delta_grid"):
            if g in params:
                params[g] = jax.tree_util.tree_map(
                    lambda p: jnp.asarray(rng.uniform(-1, 1, p.shape).astype(np.float32)),
                    params[g])
    nef_t = getattr(nefs_t, cls)(grid=grid_t, num_classes=5, num_instances=7, hidden_dim=16,
                                 compute_dtype=torch.float32, **kw)
    nef_t.load_state_dict(params_from_flax(_np_tree(params)))
    return nef_j, params, nef_t, x, d, chans


@pytest.mark.parametrize("cls, grid_kw, kw", [
    ("PanopticNeF", dict(grid_type="HashGrid", num_lods=4, log2_table_size=8), {}),
    ("PanopticNeF", dict(grid_type="TriplanarGrid", num_lods=3, feature_dim=4, base_lod=2),
     {}),
    ("PanopticDeltaNeF", dict(grid_type="HashGrid", num_lods=4, log2_table_size=8),
     dict(panoptic_features_type="delta")),
    ("PanopticDeltaNeF", dict(grid_type="OctreeGrid", num_lods=2, feature_dim=4,
                              base_lod=2), dict(panoptic_features_type="delta")),
], ids=["hash", "triplanar", "delta_hash_dual", "delta_dense_unfused"])
def test_panoptic_nefs_over_the_new_grids_match_jax(cls, grid_kw, kw):
    nef_j, params, nef_t, x, d, chans = _nef_pair(cls, grid_kw, **kw)
    if cls == "PanopticDeltaNeF":
        assert nef_t._can_fuse_dual() == (grid_kw["grid_type"] == "HashGrid")
    out_j = nef_j.apply({"params": params}, jnp.asarray(x), jnp.asarray(d), chans)
    w = {k: np.random.default_rng(len(k)).normal(size=v.shape).astype(np.float32)
         for k, v in out_j.items()}

    def loss_j(p, xx):
        out = nef_j.apply({"params": p}, xx, jnp.asarray(d), chans)
        return sum(jnp.sum(out[k] * w[k]) for k in sorted(out))
    dp_j, dx_j = jax.grad(loss_j, argnums=(0, 1))(params, jnp.asarray(x))
    xx = torch.from_numpy(x).requires_grad_()
    out_t = nef_t(xx, torch.from_numpy(d), chans)
    assert sorted(out_t) == sorted(out_j)
    for k in out_j:
        np.testing.assert_allclose(out_t[k].detach().numpy(), np.asarray(out_j[k]), rtol=0,
                                   atol=1e-5, err_msg=k)
    sum(torch.sum(out_t[k] * torch.from_numpy(w[k])) for k in sorted(out_t)).backward()
    grads_j = params_from_flax(_np_tree(dp_j))
    for n, p in nef_t.named_parameters():
        got = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        _close(got, grads_j[n].numpy(), n)
    _close(xx.grad.numpy(), dx_j, "coordinates")


def test_panoptic_nefs_refuse_tensorf_as_jax_does():
    grid = nefs_t.GridConfig(grid_type="TensoRF")
    with pytest.raises(NotImplementedError, match="TensoRF"):
        nefs_t.PanopticNeF(grid=grid)
    nef_j = nefs_j.PanopticNeF(grid=nefs_j.GridConfig(grid_type="TensoRF"))
    with pytest.raises(NotImplementedError, match="TensoRF"):
        nef_j.init(jax.random.PRNGKey(0), jnp.zeros((3, 4)), jnp.ones((3, 4)),
                   frozenset({"density"}))
