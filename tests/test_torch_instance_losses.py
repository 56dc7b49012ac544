"""The instance losses, the regularisers and the mean-shift clustering of
the port against the JAX package, on the CPU, float32:

- ``sup_contrastive_loss`` with anchor masks, an image with every pixel
  masked, an image of one label and ``pn_ratio`` 0.5 / 0.3 / 0.8: the loss
  within 1e-5 relative, its gradient within rtol 1e-4 (atol 1e-6 of the
  largest entry), finite where an image is all masked;
- ``lin_assignment_loss`` with labels past the head's width and near ties
  that the reference's second softmax decides (no exact ties: ``ROADMAP.md``
  Queue 3 item 4): loss within 1e-6, gradient within rtol 1e-4;
- ``sigma_sparsity_loss``; ``grid_tv_l1_loss`` / ``grid_tv_l2_loss`` on a
  field of random tables with JAX's window draw passed in (rtol 1e-5);
- the mean shift's chunked distances bit-equal to the one broadcast, and
  its fit and predict equal to the JAX package's (sklearn made missing);
- a tiny ``validate`` of a ``MeanShiftPanopticDeltaNeF`` against the JAX one
  (sklearn made missing there): the clustering's inputs agree, and every
  metric with each package predicting from JAX's fitted centres (the flat
  kernel's fit is not continuous in its input; see the test).
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pagnerf_tpu.losses import lin_assignment as lin_j
from pagnerf_tpu.losses import regularizers as reg_j
from pagnerf_tpu.losses import sup_contrastive as sup_j
from pagnerf_tpu.utils import clustering as clu_j
from pagnerf_tpu_torch.losses import lin_assignment as lin_t
from pagnerf_tpu_torch.losses import regularizers as reg_t
from pagnerf_tpu_torch.losses import sup_contrastive as sup_t
from pagnerf_tpu_torch.utils import clustering as clu_t
from test_torch_dd import nef_pair

torch.set_num_threads(1)


def _grad_close(got, want):
    atol = 1e-6 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)


def _contrastive_inputs(seed=0, b=3, r=40, d=6):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, r, d)).astype(np.float32)
    labels = rng.integers(0, 4, (b, r)).astype(np.int32)
    mask = rng.uniform(size=(b, r)) < 0.7
    mask[1] = False                       # an image with every pixel masked
    labels[2] = 3                         # an image of one label
    return feats, labels, mask


@pytest.mark.parametrize("pn_ratio", [0.5, 0.3, 0.8])
@pytest.mark.parametrize("masked", [False, True])
def test_sup_contrastive_matches_jax(pn_ratio, masked):
    feats, labels, mask = _contrastive_inputs()
    kw = dict(temperature=0.07, base_temperature=0.1, pn_ratio=pn_ratio)
    am_j = jnp.asarray(mask) if masked else None
    fn = lambda f: sup_j.sup_contrastive_loss(f, jnp.asarray(labels), am_j, **kw)
    want, gwant = jax.value_and_grad(fn)(jnp.asarray(feats))
    x = torch.from_numpy(feats).requires_grad_(True)
    got = sup_t.sup_contrastive_loss(x, torch.from_numpy(labels),
                                     torch.from_numpy(mask) if masked else None, **kw)
    got.backward()
    assert np.isfinite(got.item()) and float(want) != 0.0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert np.all(np.isfinite(x.grad.numpy()))
    _grad_close(x.grad.numpy(), np.asarray(gwant))
    if masked:      # the all-masked image and the one-label image add nothing
        assert not np.any(x.grad.numpy()[1:])


def test_sup_contrastive_every_pixel_masked_is_finite():
    feats, labels, _ = _contrastive_inputs()
    x = torch.from_numpy(feats).requires_grad_(True)
    loss = sup_t.sup_contrastive_loss(x, torch.from_numpy(labels),
                                      torch.zeros(labels.shape, dtype=torch.bool))
    loss.backward()
    assert float(loss) == 0.0 and np.all(x.grad.numpy() == 0.0)


def _assignment_inputs(seed, b=2, r=60, m=6):
    """Slot probabilities where each label's mean prefers slot lab + 1 (0.3
    on every pixel) over slot lab + 2 (0.59 on every other pixel of the
    label, else 0), while the reference's second softmax prefers lab + 2
    (the exponential favours the spread slot); noise of 1e-4, so no exact
    ties; and labels past the head's width."""
    rng = np.random.default_rng(seed)
    # every label (m + 2: past the width) on an even count of pixels
    labels = np.stack([rng.permutation(np.repeat(rng.integers(0, m + 1, r // 2), 2))
                       for _ in range(b)]).astype(np.int32)
    labels[labels == m] = m + 2
    probs = np.zeros((b, r, m))
    for i in range(b):
        seen = np.zeros(m + 3, int)
        for j in range(r):
            lab = labels[i, j] % m
            a, c = (lab + 1) % m, (lab + 2) % m
            probs[i, j, a] = 0.3 + rng.uniform(0, 1e-4)
            probs[i, j, c] = (0.59 if seen[labels[i, j]] % 2 == 0 else 0.0) \
                + rng.uniform(0, 1e-4)
            seen[labels[i, j]] += 1
            rest = [k for k in range(m) if k not in (a, c)]
            probs[i, j, rest] = rng.dirichlet(np.ones(len(rest))) * (
                1.0 - probs[i, j, a] - probs[i, j, c])
    return probs.astype(np.float32), labels


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lin_assignment_matches_jax(seed):
    probs, labels = _assignment_inputs(seed)
    m = probs.shape[-1]
    fn = lambda p: lin_j.lin_assignment_loss(p, jnp.asarray(labels), m)
    want, gwant = jax.value_and_grad(fn)(jnp.asarray(probs))
    x = torch.from_numpy(probs).requires_grad_(True)
    got = lin_t.lin_assignment_loss(x, torch.from_numpy(labels), m)
    got.backward()
    assert float(want) > 0.0
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)
    _grad_close(x.grad.numpy(), np.asarray(gwant))
    # labels past the head's width add nothing
    assert (labels >= m).any() and not np.any(x.grad.numpy()[labels >= m])


def test_lin_assignment_second_softmax_decides_near_ties():
    """On these inputs the matching of the raw means and that of the second
    softmax's means differ; the loss (both packages') follows the latter."""
    probs, labels = _assignment_inputs(0)
    m = probs.shape[-1]
    for p, gt in zip(torch.from_numpy(probs), torch.from_numpy(labels).long()):
        valid = (gt < m).float()
        raw, present = lin_t._label_slot_cost(p, gt, valid, m)
        soft, _ = lin_t._label_slot_cost(torch.softmax(p, -1), gt, valid, m)
        by_raw = lin_t.hungarian_assign(raw, present)
        by_soft = lin_t.hungarian_assign(soft, present)
        lab = torch.arange(m)[present]
        assert torch.equal(by_raw[lab], (lab + 1) % m)
        assert torch.equal(by_soft[lab], (lab + 2) % m)
    got = float(lin_t.lin_assignment_loss(torch.from_numpy(probs), torch.from_numpy(labels), m))
    want = float(lin_j.lin_assignment_loss(jnp.asarray(probs), jnp.asarray(labels), m))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the NLL toward slot lab + 2: -log of 0.59 or of ~1e-4 on alternate pixels
    assert got > 3.0


def test_sigma_sparsity_matches_jax():
    s = np.random.default_rng(3).normal(0, 3, (5, 17)).astype(np.float32)
    np.testing.assert_allclose(reg_t.sigma_sparsity_loss(torch.from_numpy(s)).numpy(),
                               np.asarray(reg_j.sigma_sparsity_loss(jnp.asarray(s))),
                               rtol=1e-6)


@pytest.mark.parametrize("kind", ["l1", "l2"])
def test_grid_tv_matches_jax(kind):
    nj, params, nt = nef_pair("PanopticDeltaNeF", panoptic_features_type="delta")
    key = jax.random.PRNGKey(4)
    enc_j = lambda c: nj.apply({"params": params}, c,
                               method=lambda m, cc: m._grid_feats(m.grid_module, cc.T, None).T)
    kw = dict(sample_size=0.3, num_dim_samples=12)
    want = getattr(reg_j, f"grid_tv_{kind}_loss")(enc_j, key, **kw)
    nt.requires_grad_(True)
    got = getattr(reg_t, f"grid_tv_{kind}_loss")(
        lambda c: nt._grid_feats(nt.grid, c, None),
        torch.from_numpy(np.asarray(jax.random.normal(key, (3,))).copy()), **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    got.backward()
    assert nt.grid.tables.grad.abs().max() > 0


# ------------------------------------------------------------- mean shift
@pytest.mark.parametrize("max_elems", [1, 50, 1000, 1 << 23])
def test_pair_dists_chunked_bit_equal(max_elems):
    rng = np.random.default_rng(5)
    a, b = rng.normal(size=(333, 7)), rng.normal(size=(29, 7)).astype(np.float32)
    got = clu_t.pair_dists(a, b, max_elems)
    assert np.array_equal(got, np.linalg.norm(a[:, None] - b[None], axis=-1))


def test_mean_shift_fit_predict_equal_jax_in_chunks(monkeypatch):
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    rng = np.random.default_rng(6)
    centres = rng.normal(size=(5, 8)) * 3
    emb = (centres[rng.integers(0, 5, (4, 60))] + rng.normal(0, 0.2, (4, 60, 8)))
    emb = emb.astype(np.float32)
    labels = rng.integers(0, 9, (4, 60))
    pix = rng.normal(size=(2000, 8)).astype(np.float32) * 3
    mj, mt = clu_j.MeanShift(), clu_t.MeanShift()
    mj.train_clustering(emb, labels)
    monkeypatch.setattr(clu_t, "CHUNK_ELEMS", 64)       # many chunks
    mt.train_clustering(emb, labels)
    assert np.array_equal(mt.ms.cluster_centers_, mj.ms.cluster_centers_)
    assert np.array_equal(mt.predict_clusters(pix), mj.predict_clusters(pix))


def test_mean_shift_validate_matches_jax(monkeypatch, tmp_path):
    """``validate`` of a ``MeanShiftPanopticDeltaNeF`` (raw normalised
    embeddings, the contrastive loss) on the tiny flagship, both packages on
    the same parameters, sklearn made missing on the JAX side.

    The clustering samples the same pixels: labels equal, embeddings within
    1e-5, the bandwidth within 1e-6. The flat-kernel mean shift is not
    continuous in its input: the bandwidth is the 0.3 quantile of the
    pairwise distances, which (each distance appearing twice) lands exactly
    on one of them, and ``d < bandwidth`` decides that pair by rounding (on
    these 6 centres one fitted centre moves). So each package's predict
    then runs on JAX's fitted centres: every metric agrees (PSNR within
    1e-3 dB, the rest within 1e-6)."""
    from pagnerf_tpu.train import validation as val_j
    from pagnerf_tpu_torch.train import validation as val_t
    from test_torch_train_branches import trainer_pair
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    tj, tt = trainer_pair("MeanShiftPanopticDeltaNeF",
                          nef_kw=dict(inst_softmax=False, inst_normalize=True),
                          inst_loss="sup_contrastive", inst_weight=1.0, render_batch=128,
                          num_clustering_samples=200)
    seen = {}
    for name, mod in (("jax", clu_j), ("port", clu_t)):
        fit = mod.MeanShift.train_clustering

        def spy(self, emb, labels, _fit=fit, _name=name):
            seen[_name] = (emb, labels)
            _fit(self, emb, labels)
            seen[_name + "_ms"] = self.ms
        monkeypatch.setattr(mod.MeanShift, "train_clustering", spy)
    fit_t = val_t.train_clustering

    def port_fit_on_jax_centres(*args, **kwargs):
        ms = fit_t(*args, **kwargs)
        ms.ms.cluster_centers_ = seen["jax_ms"].cluster_centers_
        return ms
    monkeypatch.setattr(val_t, "train_clustering", port_fit_on_jax_centres)
    mj = val_j.validate(tj, 1)
    mt = val_t.validate(tt, 1, log_dir=str(tmp_path))
    (ej, lj), (et, lt) = seen["jax"], seen["port"]
    assert np.array_equal(lt, lj) and len(np.unique(lj)) >= 2
    np.testing.assert_allclose(et, ej, rtol=0, atol=1e-5)
    assert abs(seen["port_ms"].bandwidth - seen["jax_ms"].bandwidth) <= 1e-6
    assert len(seen["jax_ms"].cluster_centers_) >= 2
    assert sorted(mt) == sorted(mj) and "val/pq_things" in mt
    for k, v in mj.items():
        if k != "val/render_time_per_img":
            assert abs(mt[k] - v) <= (1e-3 if k == "val/psnr" else 1e-6), (k, mt[k], v)
