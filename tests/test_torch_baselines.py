"""The baseline NeFs and the four BUP20 configs of this slice against the
JAX package, on the CPU.

- ``SemanticNeF`` and ``PanopticLiftingNeF`` (and its ``MLPRenderFeature``
  and ``_pe_T``): every channel at atol 1e-5, the parameters' and the
  coordinates' gradients at rtol 1e-4 with an atol of 1e-6 of the tensor's
  largest entry, on the JAX modules' initial parameters through
  ``convert.params_from_flax``. Samples with a layer's pre-activation
  within 1e-5 of 0 carry no loss weight: there a float32 rounding may flip
  a ReLU's derivative (one of 600 samples of the Panoptic Lifting case has
  one at 2e-8 and moves an appearance-plane entry by 8e-4).
- One tiny ``train_step`` of each config (``panoptic_nerf.yaml``: the hash
  grid; ``mean_shift_contrastive_app.yaml``: the triplanar grid;
  ``semantic_nerf_app.yaml`` and ``panoptic_lifting_app.yaml``: the
  baselines), both trainers built by their factories from the config with
  the synthetic scene at 16x12 and the width cut (4 LoDs x 2^8 tables,
  hidden 16, 16 steps, 2 images of 32 rays), float32 decoders, the port on
  the JAX trainer's initial parameters, at the epoch that renders the
  panoptic heads: the stages field for field, each microbatch's gradients
  (JAX's ``grad_step``) at rtol 1e-4 with an atol of 1e-6 of the tensor's
  largest entry (1e-5 with the contrastive loss, whose 1 / 0.07 temperature
  scales the float32 rounding of the similarities, and for
  ``semantic_nerf_app``: there one entry of the trunk's second bias differs
  by 1.5e-6, 1.5 times 1e-6 of the largest entry, in the first microbatch.
  XLA fuses the march's ``t0 + u * span`` and ``o + d * t`` into fused
  multiply-adds, so sample coordinates lie 1-2 ulp from the port's, and
  the positional embedding's 2^9 frequency makes that up to 6.4e-5 in the
  first layer; at sample 313 the second layer's unit 12 sits at -1.4e-6 in
  JAX and +1.7e-5 here, its ReLU derivative flips, and the bias entry
  takes that sample's gradient on one side only. At hidden width 32 or 24
  steps the worst entry is at a tenth of the 1e-6 tolerance), the step's
  losses at atol 1e-5.
- ``maybe_upsample_tensorf`` against the JAX trainer's on a tiny TensoRF
  run (``PanopticLiftingNeF`` over ``--grid-type TensoRF``), after one step
  of both and on the JAX trainer's parameters: the resized factors at atol
  1e-5, the moments zeroed and the counts kept, the next step's losses at
  atol 1e-5; and no upsampling under the config's own ``OctreeGrid``, as
  in the JAX package.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pagnerf_tpu.config import config as config_j
from pagnerf_tpu.config import factory as factory_j
from pagnerf_tpu.models import nefs as nefs_j
from pagnerf_tpu.models import panoptic_lifting as pl_j
from pagnerf_tpu.models import semantic_nerf as sn_j
from pagnerf_tpu_torch.config import config as config_t
from pagnerf_tpu_torch.config import factory as factory_t
from pagnerf_tpu_torch.convert import params_from_flax
from pagnerf_tpu_torch.models import nefs as nefs_t
from pagnerf_tpu_torch.models import panoptic_lifting as pl_t
from pagnerf_tpu_torch.models import semantic_nerf as sn_t
from pagnerf_tpu_torch.train.checkpoint import load_state, trainer_state
from test_torch_train_branches import step_pair

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, what, atol_rel=1e-6):
    want = np.asarray(want)
    atol = atol_rel * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=atol, err_msg=what)


def test_pe_matches_jax():
    x = np.random.default_rng(0).normal(size=(5, 40)).astype(np.float32)
    np.testing.assert_allclose(pl_t._pe_T(torch.from_numpy(x), 3).numpy(),
                               np.asarray(pl_j._pe_T(jnp.asarray(x), 3)), rtol=0, atol=1e-6)


BASELINES = {
    "semantic": (sn_j.SemanticNeF, sn_t.SemanticNeF,
                 dict(num_classes=5, hidden_dim=32, pos_multires=4, view_multires=3),
                 frozenset({"density", "rgb", "semantics"})),
    "semantic_sigmoid": (sn_j.SemanticNeF, sn_t.SemanticNeF,
                         dict(num_classes=5, hidden_dim=16, sem_softmax=False,
                              sem_sigmoid=True, sem_normalize=True),
                         frozenset({"density", "rgb", "semantics"})),
    "panoptic_lifting": (pl_j.PanopticLiftingNeF, pl_t.PanopticLiftingNeF,
                         dict(num_classes=5, num_instances=9, hidden_dim=16),
                         frozenset({"density", "rgb", "semantics", "inst_embedding"})),
    "panoptic_lifting_raw": (pl_j.PanopticLiftingNeF, pl_t.PanopticLiftingNeF,
                             dict(num_classes=5, num_instances=9, hidden_dim=16,
                                  inst_softmax=False, inst_normalize=True, sem_sigmoid=True),
                             frozenset({"density", "rgb", "semantics", "inst_embedding"})),
}


def _relu_kinks(nef_t, x, d, chans, eps=1e-5):
    """Samples where a layer's pre-activation lies within ``eps`` of 0: a
    float32 rounding there may take a ReLU's derivative to the other side
    (a kink of the function, not a fault), so their loss weights are 0 in
    both packages."""
    outs = []
    hooks = [m.register_forward_hook(lambda _m, _i, o: outs.append(o.detach()))
             for m in nef_t.modules() if type(m).__name__ == "DenseT"]
    with torch.no_grad():
        nef_t(torch.from_numpy(x), torch.from_numpy(d), chans)
    for h in hooks:
        h.remove()
    return torch.stack([(o.abs() < eps).any(0) for o in outs]).any(0).numpy()


@pytest.mark.parametrize("name", list(BASELINES))
def test_baseline_nefs_match_jax(name):
    cls_j, cls_t, kw, chans = BASELINES[name]
    grid_kw = dict(grid_type="TensoRF", density_n_comp=4, app_n_comp=6, resolution=10)
    extra_j = dict(grid=nefs_j.GridConfig(**grid_kw)) if "lifting" in name else {}
    extra_t = dict(grid=nefs_t.GridConfig(**grid_kw)) if "lifting" in name else {}
    nef_j, nef_t = cls_j(**kw, **extra_j), cls_t(**kw, **extra_t)
    rng = np.random.default_rng(len(name))
    x = rng.uniform(-1, 1, (3, 600)).astype(np.float32)
    d = rng.normal(size=(3, 600)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    params = nef_j.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(d), chans)["params"]
    nef_t.load_state_dict(params_from_flax(_np_tree(params)))
    out_j = nef_j.apply({"params": params}, jnp.asarray(x), jnp.asarray(d), chans)
    w = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in out_j.items()}
    kinks = _relu_kinks(nef_t, x, d, chans)
    for v in w.values():
        v[:, kinks] = 0.0

    def loss_j(p, xx):
        out = nef_j.apply({"params": p}, xx, jnp.asarray(d), chans)
        return sum(jnp.sum(out[k] * w[k]) for k in sorted(out))
    dp_j, dx_j = jax.grad(loss_j, argnums=(0, 1))(params, jnp.asarray(x))
    xx = torch.from_numpy(x).requires_grad_()
    out_t = nef_t(xx, torch.from_numpy(d), chans)
    assert sorted(out_t) == sorted(out_j) == sorted(chans)
    assert nef_t.supported_channels() == nef_j.supported_channels()
    for k in out_j:
        assert out_t[k].shape == out_j[k].shape
        np.testing.assert_allclose(out_t[k].detach().numpy(), np.asarray(out_j[k]), rtol=0,
                                   atol=1e-5, err_msg=k)
    sum(torch.sum(out_t[k] * torch.from_numpy(w[k])) for k in sorted(out_t)).backward()
    grads_j = params_from_flax(_np_tree(dp_j))
    assert sorted(n for n, _ in nef_t.named_parameters()) == sorted(grads_j)
    for n, p in nef_t.named_parameters():
        _close(p.grad.numpy(), grads_j[n].numpy(), f"{name}: {n}")
    _close(xx.grad.numpy(), dx_j, f"{name}: coordinates")


def test_baseline_inits_are_seeded():
    for nef in (sn_t.SemanticNeF(hidden_dim=16),
                pl_t.PanopticLiftingNeF(grid=nefs_t.GridConfig(resolution=8), hidden_dim=16)):
        states = []
        for _ in range(2):
            nef.reset_parameters(torch.Generator().manual_seed(3))
            states.append({k: v.clone() for k, v in nef.state_dict().items()})
        assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])
    nef = sn_t.SemanticNeF(hidden_dim=16)
    nef.reset_parameters(torch.Generator().manual_seed(0))
    assert float(nef.decoder_density.bias.detach()) == 1.0


# ------------------------------------------------------------ one step per config
WIDTH = ["--multiview-dataset-format", "synthetic", "--synthetic-res", "16", "12",
         "--synthetic-num-views", "4", "--num-lods", "4", "--codebook-bitwidth", "8",
         "--capacity-log-2", "8", "--delta-capacity-log-2", "8", "--hidden-dim", "16",
         "--num-steps", "16", "--batch-size", "2", "--compute-dtype", "float32",
         "--sem-epoch-start", "0"]
CONFIGS = {
    "panoptic_nerf": ("configs/bup20/panoptic_nerf.yaml", ["--inst-epoch-start", "0"]),
    "mean_shift_contrastive_app": ("configs/bup20/mean_shift_contrastive_app.yaml",
                                   ["--inst-epoch-start", "0", "--base-lod", "2"]),
    # its instance stage starts at epoch 900: SemanticNeF has no instance head
    "semantic_nerf_app": ("configs/bup20/semantic_nerf_app.yaml", []),
    "panoptic_lifting_app": ("configs/bup20/panoptic_lifting_app.yaml",
                             ["--inst-epoch-start", "0"]),
}
WANT = {"panoptic_nerf": ("MeanShiftPanopticNeF", "HashGrid", "Pipeline"),
        "mean_shift_contrastive_app": ("MeanShiftPanopticNeF", "TriplanarGrid", "BAPipeline"),
        "semantic_nerf_app": ("SemanticNeF", None, "Pipeline"),
        "panoptic_lifting_app": ("PanopticLiftingNeF", "TensoRFGrid", "Pipeline")}


def trainers_from_config(path, extra):
    argv = ["--config", os.path.join(ROOT, path)] + WIDTH + extra
    _, _, tj = factory_j.get_modules_from_config(config_j.parse_options(argv))
    pipe, _, tt = factory_t.get_modules_from_config(config_t.parse_options(argv), "cpu")
    pipe.load_state_dict(params_from_flax(_np_tree(tj.params)))
    return tj, tt


@pytest.fixture(scope="module", params=list(CONFIGS))
def config_run(request):
    tj, tt = trainers_from_config(*CONFIGS[request.param])
    return dict(step_pair(tj, tt), name=request.param, tt=tt)


def test_config_builds_the_jax_modules(config_run):
    tt, (nef, grid, pipe) = config_run["tt"], WANT[config_run["name"]]
    assert type(tt.pipeline.nef).__name__ == nef and type(tt.pipeline).__name__ == pipe
    assert type(getattr(tt.pipeline.nef, "grid", None)).__name__ == (grid or "NoneType")
    stage = config_run["stage_t"]
    assert dataclasses.asdict(stage) == dataclasses.asdict(config_run["stage_j"])
    assert stage.use_sem
    assert stage.use_inst == (config_run["name"] != "semantic_nerf_app")


def test_config_step_losses_match_jax(config_run):
    lj, lt = config_run["losses_j"], config_run["losses_t"]
    assert sorted(lt) == sorted(lj) and "sem_loss" in lt
    for k in lj:
        assert np.isfinite(lt[k])
        np.testing.assert_allclose(lt[k], lj[k], rtol=1e-6 if k == "total_loss" else 0.0,
                                   atol=1e-5, err_msg=k)


def test_config_gradients_match_jax(config_run):
    contrastive = config_run["tt"].cfg.inst_loss == "sup_contrastive"
    looser = (contrastive and config_run["stage_t"].use_inst
              or config_run["name"] == "semantic_nerf_app")
    atol_rel = 1e-5 if looser else 1e-6
    for gj, gt in zip(config_run["grads_j"], config_run["grads_t"]):
        assert sorted(gt) == sorted(gj)
        for name in gj:
            _close(gt[name].numpy(), gj[name].numpy(), f"{config_run['name']}: {name}",
                   atol_rel)
    assert any(np.any(g[n].numpy()) for g in config_run["grads_t"] for n in g
               if ".grid." in n or config_run["name"] == "semantic_nerf_app")


@pytest.mark.parametrize("grid_type", ["TensoRF", "OctreeGrid"])
def test_tensorf_upsampling_matches_jax(grid_type):
    path, extra = CONFIGS["panoptic_lifting_app"]
    tj, tt = trainers_from_config(path, extra + ["--grid-type", grid_type, "--epochs", "5"])
    step_pair(tj, tt)                             # moments and counts to carry
    # the same parameters on both sides (Adam's first step takes each
    # entry by about +-lr, whatever the size of its gradient, so an entry
    # with a gradient within rounding of 0 may move either way)
    with torch.no_grad():
        for name, p in params_from_flax(_np_tree(tj.params)).items():
            tt.params[name].copy_(p)
    counts = dict(tt.opt.count)
    assert any(m.any() for m in tt.opt.mu.values())
    tj.maybe_upsample_tensorf(1)
    tt.maybe_upsample_tensorf(1)
    res = 144 if grid_type == "TensoRF" else 128
    assert tt.pipeline.nef.grid.density_plane.shape[-1] == res
    assert tt.pipeline.nef.grid_cfg.resolution == tj.pipeline.nef.grid.resolution == res
    params_j = params_from_flax(_np_tree(tj.params))
    for name, p in tt.pipeline.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), params_j[name].numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
    assert tt.opt.count == counts and set(tt.opt.params) == set(tt.params)
    if grid_type == "TensoRF":
        assert all(not m.any() for m in tt.opt.mu.values())
        assert all(tt.opt.mu[n].shape == p.shape for n, p in tt.params.items())
    out = step_pair(tj, tt)
    for k, v in out["losses_j"].items():
        np.testing.assert_allclose(out["losses_t"][k], v, rtol=0, atol=1e-5, err_msg=k)
    # a checkpoint of the upsampled grid restores into a freshly built trainer
    _, fresh = trainers_from_config(path, extra + ["--grid-type", grid_type, "--epochs", "5"])
    load_state(fresh, trainer_state(tt))
    assert fresh.pipeline.nef.grid.density_plane.shape[-1] == res
    for name, p in tt.params.items():
        assert torch.equal(fresh.params[name], p), name
        assert torch.equal(fresh.opt.mu[name], tt.opt.mu[name]), name
