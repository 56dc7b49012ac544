"""Checkpoints of the port, and a JAX checkpoint continued in the port, on
the CPU.

- A trainer's state round-trips bit-exactly through ``save_checkpoint`` /
  ``load_checkpoint`` in all four formats: parameters, each group's Adam
  moments and count, occupancy, mask and level, LoD weights, epoch, global
  step and the prune flags (``full``, ``state_dict``); the parameters only
  (``params_only``); matching parameters only, the others kept
  (``params_only_ignore_missmatch``). The write is atomic and the file
  loads with ``weights_only=True``.
- ``_partial_merge`` and ``derive_real_pruned`` behave as the JAX
  package's, and a state without the prune flags is restored as the JAX
  package restores one.
- A checkpoint written by ``pagnerf_tpu.train.checkpoint.save_checkpoint``
  after JAX training steps and the scene fixture's prune state, read with
  flax and passed through ``convert.state_from_jax``: the port's trainer
  holds the same parameters, moments and counts, and its final validation
  (the voxel march and the packed layout, as test_torch_validation.py
  renders it) equals
  the JAX trainer's (channels within rtol 3e-5 / atol 3e-6, metrics within
  1e-6, PSNR within 1e-3 dB), the JAX march run op by op. (With the ray
  march the camera transform's last-ulp rounding, JAX's against torch's,
  can put a midpoint sample on the other side of a cell face: 4 of 768 rays
  of one tiny 'val' camera.)
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as flax_ser

from pagnerf_tpu.train import checkpoint as ckpt_j
from pagnerf_tpu.train import validation as val_j
from pagnerf_tpu.train.trainer import TrainerConfig as CfgJ
from pagnerf_tpu_torch.config import config as config_t
from pagnerf_tpu_torch.config import factory as factory_t
from pagnerf_tpu_torch.convert import state_from_jax
from pagnerf_tpu_torch.train import checkpoint as ckpt_t
from pagnerf_tpu_torch.train import validation as val_t
from pagnerf_tpu_torch.train.trainer import TrainerConfig
from test_torch_validation import (_assert_channels_close, _capture, _fixture_occupancy,
                                   _trainer_pair, op_by_op)  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--config", os.path.join(ROOT, "configs", "synthetic", "tiny.yaml"),
        "--lod-anneling", "--lod-annel-epochs", "2", "--use-lr-scheduler",
        "--lr-step-size", "1", "--num-rays-sampled-per-img", "16", "--blas-level", "5"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops in one thread: beside five busy test workers, torch's
    spinning intra-op threads took a 5 s tiny CLI run to 293 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trainer(seed=0):
    return factory_t.get_modules_from_config(config_t.parse_options(TINY), "cpu",
                                             seed=seed)[2]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A trainer after an annealed epoch, a seed prune and a real prune,
    saved to disk."""
    t = _trainer()
    t.run_epoch(0)
    t.prune(seed=True)
    t.prune()
    t.run_epoch(1)
    path = ckpt_t.save_checkpoint(str(tmp_path_factory.mktemp("ckpt") / "model.ckpt"), t)
    return t, path


def _assert_same_state(a, b, opt=True):
    for n, p in a.params.items():
        assert torch.equal(p, b.params[n]), n
    if opt:
        assert a.opt.count == b.opt.count
        for n in a.opt.mu:
            assert torch.equal(a.opt.mu[n], b.opt.mu[n]) and torch.equal(a.opt.nu[n],
                                                                          b.opt.nu[n]), n
        assert torch.equal(a.occ.occupancy, b.occ.occupancy)
        assert torch.equal(a.occ.mask, b.occ.mask) and a.occ.level == b.occ.level
        assert torch.equal(a.lod_w, b.lod_w)
        assert (a.epoch, a.global_step, a._pruned, a._real_pruned, a._occ_frac) == \
            (b.epoch, b.global_step, b._pruned, b._real_pruned, b._occ_frac)


@pytest.mark.parametrize("fmt", ["full", "state_dict"])
def test_round_trip_is_bit_exact(trained, fmt):
    t, path = trained
    assert t._real_pruned and t.opt.count["grid"] == 2 * t.steps_per_epoch
    assert not torch.all(t.lod_w == 1) and not bool(t.occ.mask.all())
    fresh = _trainer(seed=1)
    assert not torch.equal(fresh.params["nef.grid.tables"], t.params["nef.grid.tables"])
    ckpt_t.load_checkpoint(path, fresh, fmt)
    _assert_same_state(t, fresh)
    # and it trains on from there as the original does
    assert fresh.stage_for_epoch(fresh.epoch) == t.stage_for_epoch(t.epoch)


def test_params_only_restores_parameters_alone(trained):
    t, path = trained
    fresh = _trainer(seed=1)
    ckpt_t.load_checkpoint(path, fresh, "params_only")
    _assert_same_state(t, fresh, opt=False)
    assert fresh.epoch == 0 and fresh.opt.count["grid"] == 0 and not fresh._pruned
    assert bool(fresh.occ.mask.all())


def test_ignore_mismatch_keeps_current_entries(trained, tmp_path):
    t, path = trained
    state = torch.load(path, weights_only=True)
    state["params"]["nef.grid.tables"] = torch.zeros(3, 3)
    del state["params"]["extrinsics"]
    torch.save(state, tmp_path / "bad.ckpt")
    fresh = _trainer(seed=1)
    before = {n: p.clone() for n, p in fresh.params.items()}
    ckpt_t.load_checkpoint(str(tmp_path / "bad.ckpt"), fresh, "params_only_ignore_missmatch")
    for n, p in fresh.params.items():
        want = before[n] if n in ("nef.grid.tables", "extrinsics") else t.params[n]
        assert torch.equal(p, want), n
    state["params"]["extrinsics"] = t.params["extrinsics"]
    torch.save(state, tmp_path / "mismatch.ckpt")
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt_t.load_checkpoint(str(tmp_path / "mismatch.ckpt"), _trainer(), "params_only")
    state["params"]["nef.grid.tables"] = t.params["nef.grid.tables"]
    del state["params"]["extrinsics"]
    torch.save(state, tmp_path / "missing.ckpt")
    with pytest.raises(KeyError, match="missing parameter extrinsics"):
        ckpt_t.load_checkpoint(str(tmp_path / "missing.ckpt"), _trainer(), "full")
    with pytest.raises(ValueError, match="model_format"):
        ckpt_t.load_checkpoint(path, _trainer(), "pickle")


def test_save_is_atomic_and_data_only(trained, tmp_path):
    t, _ = trained
    path = ckpt_t.save_checkpoint(str(tmp_path / "m.ckpt"), t, save_as_new=True)
    assert path == str(tmp_path / f"m_epoch{t.epoch}.ckpt")
    assert sorted(os.listdir(tmp_path)) == [f"m_epoch{t.epoch}.ckpt"]
    state = torch.load(path, weights_only=True)
    assert sorted(state) == sorted(ckpt_t.trainer_state(t))
    assert state["opt_state"]["count"] == t.opt.count


# --------------------------------------------------- as the JAX package
def test_partial_merge_as_jax():
    rng = np.random.default_rng(0)
    r = lambda *shape: rng.normal(size=shape).astype(np.float32)
    cur = {"a": {"x": r(2, 3), "y": r(4)}, "b": r(1)}
    good = {"a": {"x": r(2, 3), "y": r(4)}, "b": r(1)}
    bad = {"a": {"x": r(3, 3)}, "b": r(1)}
    flat = lambda tree: {".".join(str(getattr(k, "key", k)) for k in kp): torch.from_numpy(
        np.array(v)) for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    for loaded in (good, bad):
        for ignore in (False, True):
            try:
                want = flat(ckpt_j._partial_merge(cur, loaded, ignore))
            except (ValueError, KeyError) as e:
                with pytest.raises(type(e)):
                    ckpt_t._partial_merge(flat(cur), flat(loaded), ignore)
                continue
            got = ckpt_t._partial_merge(flat(cur), flat(loaded), ignore)
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)


@pytest.mark.parametrize("kw", [dict(), dict(prune_every=25), dict(prune_at_epoch=7),
                                dict(prune_at_start=True), dict(prune_every=-1),
                                dict(prune_every=-1, prune_at_epoch=3, prune_at_start=True)])
def test_derive_real_pruned_as_jax(kw):
    cfg_t = TrainerConfig(**kw)
    cfg_j = CfgJ(**dataclasses.asdict(cfg_t))
    assert ckpt_t._first_real_prune_epoch(cfg_t) == ckpt_j._first_real_prune_epoch(cfg_j)
    for epoch in (0, 1, 3, 4, 7, 8, 25, 26, 300):
        for pruned in (False, True):
            assert ckpt_t.derive_real_pruned(cfg_t, epoch, pruned) == \
                ckpt_j.derive_real_pruned(cfg_j, epoch, pruned)


def test_state_without_prune_flags_is_derived(trained):
    t, path = trained
    state = torch.load(path, weights_only=True)
    for k in ("pruned", "real_pruned", "occ_frac"):
        del state[k]
    fresh = _trainer(seed=1)
    ckpt_t.load_state(fresh, state, "full")
    frac = float(t.occ.mask.float().mean())
    assert fresh._pruned == (frac < 1.0) and fresh._occ_frac == frac
    assert fresh._real_pruned == ckpt_t.derive_real_pruned(fresh.cfg, t.epoch, fresh._pruned)


# ------------------------------------------- a JAX checkpoint in the port
def test_jax_checkpoint_continues_in_the_port(monkeypatch, op_by_op, tmp_path):  # noqa: F811
    tj, tt = _trainer_pair(render_batch=128, sem_epoch_start=2, inst_epoch_start=2)
    # JAX training steps give moments and counts, then the prune state
    for epoch in range(2):
        tj.run_epoch(epoch)
    _fixture_occupancy(tj, tt)
    tj.lod_w = jnp.asarray(np.linspace(0.5, 1.0, tj.lod_w.shape[0], dtype=np.float32))
    tj.epoch = tj.cfg.epochs
    path = ckpt_j.save_checkpoint(str(tmp_path / "jax.ckpt"), tj)
    with open(path, "rb") as f:
        state = state_from_jax(flax_ser.msgpack_restore(f.read()))
    ckpt_t.load_state(tt, state, "full")

    p_j = {".".join(str(k.key) for k in kp): np.asarray(v)
           for kp, v in jax.tree_util.tree_flatten_with_path(tj.params)[0]}
    assert sorted(p_j) == sorted(tt.params)
    for n, v in p_j.items():
        np.testing.assert_array_equal(tt.params[n].detach().numpy(), v, err_msg=n)
    inner = tj.opt_state.inner_states
    for grp, count in tt.opt.count.items():
        assert count == int(inner[grp].inner_state[0].count) == 2 * tt.steps_per_epoch
    for kp, v in jax.tree_util.tree_flatten_with_path(inner["grid"].inner_state[0].mu)[0]:
        np.testing.assert_array_equal(tt.opt.mu["nef.grid.tables"].numpy(), np.asarray(v))
    np.testing.assert_array_equal(tt.lod_w.numpy(), np.asarray(tj.lod_w))
    assert (tt.epoch, tt.global_step, tt._pruned, tt._real_pruned) == (
        tj.epoch, tj.global_step, True, True)
    assert tt._occ_frac == tj._occ_frac

    for t in (tj, tt):
        t.dataset.data = __import__(
            "pagnerf_tpu.data.synthetic" if t is tj else "pagnerf_tpu_torch.data.synthetic",
            fromlist=["x"]).add_synthetic_predictions(t.dataset.data)
    seen_j, seen_t = _capture(tj, monkeypatch), _capture(tt, monkeypatch)
    mj = val_j.validate(tj, tj.epoch)
    mt = val_t.validate(tt, tt.epoch)
    assert sorted(mt) == sorted(mj) and len(seen_t) == len(seen_j) == 2
    for rb_t, rb_j in zip(seen_t, seen_j):
        _assert_channels_close(rb_t, rb_j, "validate")
    for k, v in mj.items():
        if k != "val/render_time_per_img":
            assert abs(mt[k] - v) <= (1e-3 if k == "val/psnr" else 1e-6), (k, mt[k], v)
