"""The delta-density (DD) slice of the port against the JAX package, on the
CPU, float32, at 4 LoDs x 2^8:

- ``PanopticDDensityNeF``: every channel within 1e-5, fused and unfused
  dual encode, ``separate_sem_grid`` on and off, ``delta_num_layers`` 0 and
  1; the parameters' gradients of a weighted sum of every channel against
  ``jax.grad`` within rtol 1e-4; ``panoptic_density`` sends no gradient to
  the main grid or the density decoder;
- the DD trace, dense, per-ray compacted and packed: outputs and
  ``panoptic_alpha`` within 1e-5, gradients within rtol 1e-4; the DD alpha
  differs from the colour alpha;
- a DD tracer over a NeF without ``panoptic_density`` raises the same
  ``KeyError`` in both packages;
- the chunked trace (``ray_chunk``, ``sample_chunk``) with the ray-sparsity
  loss in training, dense and packed, against JAX's ``trace`` (gradients at
  rtol 1e-4 with an atol of 1e-5 of the tensor's largest entry: the blocks'
  gradients add in another order than JAX's scan, and an entry whose terms
  cancel keeps their float32 rounding);
- a JAX DD NeF's checkpoint through ``convert.state_from_jax`` renders as
  the JAX one does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pagnerf_tpu.core.rays import Rays as RaysJ
from pagnerf_tpu.models import nefs as nefs_j
from pagnerf_tpu.models import tracer as tracer_j
from pagnerf_tpu.ops.occupancy import OccupancyGrid as OccJ
from pagnerf_tpu_torch.convert import params_from_flax
from pagnerf_tpu_torch.core.rays import Rays as RaysT
from pagnerf_tpu_torch.models import nefs as nefs_t
from pagnerf_tpu_torch.models import tracer as tracer_t
from pagnerf_tpu_torch.ops.occupancy import OccupancyGrid as OccT

torch.set_num_threads(1)

GRID_J = nefs_j.GridConfig(grid_type="PermutoGrid", num_lods=4, feature_dim=2,
                           capacity_log2=8, coarsest_scale=1.0, finest_scale=0.05)
GRID_T = nefs_t.GridConfig(num_lods=4, feature_dim=2, capacity_log2=8,
                           coarsest_scale=1.0, finest_scale=0.05)
NEF_KW = dict(num_classes=3, num_instances=5, hidden_dim=16)
ALL = frozenset({"density", "rgb", "delta_density", "panoptic_density", "semantics",
                 "inst_embedding"})


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def nef_pair(cls="PanopticDDensityNeF", seed=1, **kw):
    """The JAX NeF ``cls`` and the port's, on the same parameters (random
    tables, so the features matter): (nef_j, params_j, nef_t)."""
    rng = np.random.default_rng(seed)
    nj = getattr(nefs_j, cls)(grid=GRID_J, **NEF_KW, **kw)
    x = jnp.asarray(rng.uniform(-1, 1, (3, 8)).astype(np.float32))
    params = nj.init(jax.random.PRNGKey(seed), x, x, nj.supported_channels())["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.asarray(rng.uniform(-1, 1, v.shape), v.dtype)
        if "tables" in jax.tree_util.keystr(p) else v, params)
    nt = getattr(nefs_t, cls)(grid=GRID_T, **NEF_KW, **kw)
    nt.load_state_dict(params_from_flax(_np_tree(params)))
    return nj, params, nt


def _samples(n=400, seed=5):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (3, n)).astype(np.float32)
    dirs = rng.normal(size=(3, n)).astype(np.float32)
    return coords, dirs / np.linalg.norm(dirs, axis=0, keepdims=True)


def _assert_grads_close(got, want, what="", atol_rel=1e-6):
    """rtol 1e-4; atol ``atol_rel`` of the tensor's largest entry (at least
    of 1), for entries whose terms cancel."""
    assert sorted(got) == sorted(want), what
    for k in want:
        w = np.asarray(want[k])
        atol = atol_rel * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=atol, err_msg=f"{what} {k}")


def _port_grads(module):
    return {k: (np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy())
            for k, p in module.named_parameters()}


DD_VARIANTS = {f"{'fused' if fuse else 'unfused'}_{'separate' if sep else 'delta'}_dl{dl}":
               dict(fuse_dual_grid=fuse, separate_sem_grid=sep, delta_num_layers=dl)
               for fuse in (True, False) for sep in (False, True) for dl in (0, 1)}


@pytest.mark.parametrize("variant", list(DD_VARIANTS))
def test_dd_nef_matches_jax(variant):
    kw = dict(DD_VARIANTS[variant], panoptic_features_type="delta", delta_hidden_dim=8)
    nj, params, nt = nef_pair(**kw)
    coords, dirs = _samples()
    rng = np.random.default_rng(7)
    lod_w = rng.uniform(0.5, 1.0, (GRID_J.output_dim,)).astype(np.float32)
    out_j = nj.apply({"params": params}, jnp.asarray(coords), jnp.asarray(dirs), ALL,
                     jnp.asarray(lod_w))
    nt.requires_grad_(True)
    out_t = nt(torch.from_numpy(coords), torch.from_numpy(dirs), ALL, torch.from_numpy(lod_w))
    assert sorted(out_t) == sorted(out_j) == sorted(ALL)
    for ch in ALL:
        np.testing.assert_allclose(out_t[ch].detach().numpy(), np.asarray(out_j[ch]),
                                   rtol=0, atol=1e-5, err_msg=ch)
    assert float(out_t["panoptic_density"].detach().min()) >= 0.0
    assert (out_t["panoptic_density"] > 0).any() and (out_t["panoptic_density"] == 0).any()
    # gradients of a weighted sum of every channel
    cot = {ch: rng.normal(size=np.asarray(out_j[ch]).shape).astype(np.float32) for ch in ALL}

    def loss_j(p):
        o = nj.apply({"params": p}, jnp.asarray(coords), jnp.asarray(dirs), ALL,
                     jnp.asarray(lod_w))
        return sum(jnp.sum(o[ch] * cot[ch]) for ch in ALL)
    sum(torch.sum(out_t[ch] * torch.from_numpy(cot[ch])) for ch in ALL).backward()
    _assert_grads_close(_port_grads(nt), params_from_flax(_np_tree(jax.grad(loss_j)(params))),
                        variant)


@pytest.mark.parametrize("separate", [False, True])
def test_panoptic_density_sends_no_gradient_to_main_grid(separate):
    """As ``tests/test_models.py`` checks for JAX: the DD channel reaches the
    delta grid and the delta-density head only, and (the delta grid reads
    detached coordinates, on the dual encode's B side too) not the
    coordinates, so not the pose."""
    _, _, nt = nef_pair(panoptic_features_type="delta", separate_sem_grid=separate)
    nt.requires_grad_(True)
    coords, dirs = _samples()
    x = torch.from_numpy(coords).requires_grad_(True)
    out = nt(x, torch.from_numpy(dirs), frozenset({"panoptic_density"}))
    out["panoptic_density"].sum().backward()
    assert x.grad is None or not x.grad.any()
    g = _port_grads(nt)
    assert not np.any(g["grid.tables"]) and not any(
        np.any(v) for k, v in g.items() if k.startswith("decoder_density"))
    assert np.any(g["delta_grid.tables"]) and np.any(g["decoder_delta_density.lout.kernel"])


def test_dd_supported_channels_and_fuse_predicate():
    _, _, nt = nef_pair(panoptic_features_type="appearance")
    assert nt.supported_channels() == ALL
    # the DD NeF fuses whatever the feature type says; the delta NeF does not
    assert nt._can_fuse_dual(check_pft=False) and not nt._can_fuse_dual()


# ------------------------------------------------------------------ trace
def _rays(n=48, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = (-o + rng.normal(0, 0.5, (n, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _occ_pair(level=4, seed=1):
    mask = np.random.default_rng(seed).uniform(size=((2 ** level) ** 3,)) < 0.6
    occ_t = OccT.create(level=level)
    occ_t.mask = torch.from_numpy(mask)
    return OccJ.create(level=level).replace(mask=jnp.asarray(mask)), occ_t


TRACE_CHANNELS = frozenset({"rgb", "depth", "semantics", "inst_embedding"})


def trace_pair(nef_j, params, nef_t, cfg_kw, channels=TRACE_CHANNELS, stage="val",
               n=48, key_seed=3, chunked_jitter=False):
    """The JAX and the port trace of the same rays and occupancy with the
    same jitter: (rb_j, loss_j grads, rb_t, port grads) for a weighted sum
    of the float outputs."""
    cfg_j = tracer_j.TracerConfig(**cfg_kw)
    cfg_t = tracer_t.TracerConfig(**cfg_kw)
    o, d = _rays(n)
    occ_j, occ_t = _occ_pair()
    key = jax.random.PRNGKey(key_seed)
    steps = cfg_kw["num_steps"]
    if chunked_jitter:
        blk = cfg_kw["ray_chunk"]
        nb = -(-n // blk)
        jit = np.concatenate([np.asarray(jax.random.uniform(k, (blk, steps)))
                              for k in jax.random.split(key, nb)])
    else:
        jit = np.asarray(jax.random.uniform(key, (n, steps)))
    rays_j = RaysJ(origins=jnp.asarray(o), dirs=jnp.asarray(d),
                   dist_min=jnp.float32(0.0), dist_max=jnp.float32(6.0))

    def render_j(p):
        fn = lambda c, dd, ch: nef_j.apply({"params": p}, c, dd, ch)
        return tracer_j.trace(fn, rays_j, occ_j, cfg_j, channels, stage, key)
    rb_j = render_j(params)
    names = [f.name for f in dataclasses.fields(rb_j)
             if getattr(rb_j, f.name) is not None and f.name != "hit"]
    rng = np.random.default_rng(9)
    cot = {k: rng.normal(size=np.shape(getattr(rb_j, k))).astype(np.float32) for k in names}

    def loss_j(p):
        rb = render_j(p)
        return sum(jnp.sum(getattr(rb, k) * cot[k]) for k in names)
    grads_j = params_from_flax(_np_tree(jax.grad(loss_j)(params)))

    nef_t.requires_grad_(True)
    nef_t.zero_grad()
    rays_t = RaysT(origins=torch.from_numpy(o), dirs=torch.from_numpy(d), dist_min=0.0,
                   dist_max=6.0)
    rb_t = tracer_t.trace(lambda c, dd, ch: nef_t(c, dd, ch), rays_t, occ_t, cfg_t,
                          channels, stage, torch.from_numpy(jit.copy()))
    sum(torch.sum(getattr(rb_t, k) * torch.from_numpy(cot[k])) for k in names).backward()
    return rb_j, grads_j, rb_t, _port_grads(nef_t), names


def _assert_trace_close(rb_t, rb_j, names, what):
    for k in names + ["hit"]:
        got, want = getattr(rb_t, k).detach().numpy(), np.asarray(getattr(rb_j, k))
        if k == "hit":
            np.testing.assert_array_equal(got, want, err_msg=what)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=f"{what} {k}")


LAYOUTS = {"dense": {}, "compacted": {"compact_steps": 8}, "packed": {"pack_steps": 8}}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_dd_trace_matches_jax(layout):
    nj, params, nt = nef_pair(panoptic_features_type="delta")
    cfg = dict(tracer_type="PanopticDDensityPackedRFTracer", num_steps=16,
               ray_max_travel=2.0, **LAYOUTS[layout])
    rb_j, gj, rb_t, gt, names = trace_pair(nj, params, nt, cfg)
    assert "panoptic_alpha" in names
    _assert_trace_close(rb_t, rb_j, names, layout)
    _assert_grads_close(gt, gj, layout)
    # the DD transmittance is its own
    assert (rb_t.panoptic_alpha - rb_t.alpha).abs().max().item() > 1e-3
    assert np.any(gt["decoder_delta_density.lout.kernel"])


@pytest.mark.parametrize("cls", ["PanopticNeF", "PanopticDeltaNeF"])
def test_dd_tracer_over_a_nef_without_panoptic_density_raises_as_jax(cls):
    kw = {} if cls == "PanopticNeF" else {"panoptic_features_type": "delta"}
    nj, params, nt = nef_pair(cls, **kw)
    cfg = dict(tracer_type="PanopticDDensityPackedRFTracer", num_steps=8)
    channels = frozenset({"rgb", "semantics"})
    with pytest.raises(KeyError, match="panoptic_density"):
        trace_pair(nj, params, nt, cfg, channels)
    with pytest.raises(KeyError, match="panoptic_density"):
        o, d = _rays(8)
        tracer_t.trace(lambda c, dd, ch: nt(c, dd, ch),
                       RaysT(torch.from_numpy(o), torch.from_numpy(d), 0.0, 6.0),
                       _occ_pair()[1], tracer_t.TracerConfig(**cfg), channels)
    # without a panoptic channel nothing asks for it
    o, d = _rays(8)
    rb = tracer_t.trace(lambda c, dd, ch: nt(c, dd, ch),
                        RaysT(torch.from_numpy(o), torch.from_numpy(d), 0.0, 6.0),
                        _occ_pair()[1], tracer_t.TracerConfig(**cfg), frozenset({"rgb"}))
    assert rb.panoptic_alpha is None


CHUNKED = {"ray_chunk_dense": dict(ray_chunk=20),
           "ray_chunk_packed": dict(ray_chunk=20, pack_steps=6),
           "sample_chunk_dense": dict(sample_chunk=100),
           "sample_chunk_packed_dd": dict(sample_chunk=100, pack_steps=6,
                                          tracer_type="PanopticDDensityPackedRFTracer")}


@pytest.mark.parametrize("case", list(CHUNKED))
def test_chunked_trace_with_ray_sparsity_matches_jax(case):
    """48 rays in blocks of 20 (the last one padded, as in JAX) or samples
    in chunks of 100, the ray-sparsity loss on (training)."""
    kw = dict(CHUNKED[case])
    nj, params, nt = nef_pair(panoptic_features_type="delta")
    cfg = dict(dict(tracer_type="PanopticPackedRFTracer"), num_steps=12,
               ray_max_travel=2.0, ray_sparsity_reg=0.01, **kw)
    rb_j, gj, rb_t, gt, names = trace_pair(nj, params, nt, cfg, stage="train",
                                           chunked_jitter="ray_chunk" in kw)
    assert "ray_sparsity_loss" in names and rb_t.ray_sparsity_loss.shape == ()
    assert rb_t.rgb.shape == (48, 3)
    _assert_trace_close(rb_t, rb_j, names, case)
    # the blocks' and chunks' gradients add in another order than JAX's scan
    _assert_grads_close(gt, gj, case, atol_rel=1e-5)
    # the same trace unchunked: the chunks change no output
    plain = dataclasses.replace(tracer_t.TracerConfig(**cfg), ray_chunk=0, sample_chunk=0)
    if "sample_chunk" in kw:
        o, d = _rays(48)
        with torch.no_grad():
            rb_p = tracer_t.trace(lambda c, dd, ch: nt(c, dd, ch),
                                  RaysT(torch.from_numpy(o), torch.from_numpy(d), 0.0, 6.0),
                                  _occ_pair()[1], plain, TRACE_CHANNELS, "train",
                                  torch.from_numpy(np.array(jax.random.uniform(
                                      jax.random.PRNGKey(3), (48, 12)))))
        np.testing.assert_allclose(rb_p.rgb.numpy(), rb_t.rgb.detach().numpy(), atol=1e-6)


def test_ray_sparsity_only_in_training():
    nj, params, nt = nef_pair(panoptic_features_type="delta")
    o, d = _rays(8)
    cfg = tracer_t.TracerConfig(num_steps=8, ray_sparsity_reg=0.5)
    rays = RaysT(torch.from_numpy(o), torch.from_numpy(d), 0.0, 6.0)
    with torch.no_grad():
        assert tracer_t.trace(lambda c, dd, ch: nt(c, dd, ch), rays, _occ_pair()[1], cfg,
                              frozenset({"rgb"})).ray_sparsity_loss is None
        assert tracer_t.trace(lambda c, dd, ch: nt(c, dd, ch), rays, _occ_pair()[1], cfg,
                              frozenset({"rgb"}), "train").ray_sparsity_loss > 0


def test_jax_dd_checkpoint_renders_in_the_port(tmp_path):
    """A JAX ``PanopticDDensityNeF`` pipeline's checkpoint (its parameters,
    ``decoder_delta_density`` included, the optimizer state and the
    occupancy) through ``convert.state_from_jax`` into the port's trainer:
    the same parameters, and ``batch_render`` of every channel under the DD
    tracer within 1e-5 of JAX's."""
    from flax import serialization as flax_ser

    from pagnerf_tpu.train import checkpoint as ckpt_j
    from pagnerf_tpu.train.trainer import StageConfig as StageJ
    from pagnerf_tpu_torch.convert import state_from_jax
    from pagnerf_tpu_torch.train import checkpoint as ckpt_t
    from pagnerf_tpu_torch.train.trainer import StageConfig
    from test_torch_train_branches import trainer_pair
    tj, tt = trainer_pair("PanopticDDensityNeF",
                          tracer_kw=dict(tracer_type="PanopticDDensityPackedRFTracer"),
                          render_batch=64)
    tj.run_epoch(0)                      # moments and counts to carry over
    path = ckpt_j.save_checkpoint(str(tmp_path / "jax.ckpt"), tj)
    with open(path, "rb") as f:
        state = state_from_jax(flax_ser.msgpack_restore(f.read()))
    assert "nef.decoder_delta_density.lout.kernel" in state["params"]
    ckpt_t.load_state(tt, state, "full")
    for kp, v in jax.tree_util.tree_flatten_with_path(tj.params)[0]:
        name = ".".join(str(k.key) for k in kp)
        np.testing.assert_array_equal(tt.params[name].detach().numpy(), np.asarray(v), name)
    imgs = tt.dataset.get_images("val", mip=0)
    o, d = imgs["base_rays_origins"].reshape(-1, 3), imgs["base_rays_dirs"].reshape(-1, 3)
    cam = int(imgs["cam_idx"][0])
    chans = {"rgb", "depth", "semantics", "inst_embedding"}
    stage = dict(channels=frozenset(chans), raymarch_type="ray", num_steps=16,
                 compact_steps=0, pack_steps=0, use_sem=True, use_inst=True,
                 use_inst_segment_reg=False, training_val_poses=False, extrinsics_on=False)
    rb_j = tj.batch_render(RaysJ(origins=jnp.asarray(o), dirs=jnp.asarray(d),
                                 dist_min=jnp.float32(0.0), dist_max=jnp.float32(6.0)),
                           chans, cam_idx=cam, stage_cfg=StageJ(**stage))
    rb_t = tt.batch_render(RaysT(origins=torch.from_numpy(o), dirs=torch.from_numpy(d),
                                 dist_min=0.0, dist_max=6.0),
                           chans, cam_idx=cam, stage_cfg=StageConfig(**stage))
    for ch in sorted(chans) + ["panoptic_alpha"]:
        np.testing.assert_allclose(getattr(rb_t, ch).numpy(), np.asarray(getattr(rb_j, ch)),
                                   rtol=0, atol=1e-5, err_msg=ch)
    assert float((rb_t.panoptic_alpha - rb_t.alpha).abs().max()) > 1e-3
