"""The port's apps (``pagnerf_tpu_torch/app``), its interactive entry and its
ASHA sweep against the JAX package's, on the CPU.

- The orbit renderer on the tiny flagship (float32 decoders) from the same
  converted parameters as ``pagnerf_tpu/app/orbit_renderer.py`` on the JAX
  trainer: ``render_channels_for_view`` and ``render_channels_for_pose``
  -- rgb within 1 level of 255, depth colours within 2, semantic and
  instance colours equal wherever the JAX scores' top two differ by more
  than 1e-4 (the renders agree within rtol 3e-5, tests/
  test_torch_validation.py); ``pose_from_orbit`` exact;
  ``embedding_distance_image`` on one embedding map exact, on each
  package's own within 1 level; ``render_orbit`` on views [1, 3]: each
  ``<channel>_<view>.png`` decodes to its own view's frame (the JAX
  package's PNG strip would name frame 0 after view 0 and frame 1 after
  view 1), the strip under ``video/`` in the views' order.
- The viewer over HTTP, as ``tests/test_viewer.py`` drives the JAX one:
  the page, ``/api/info``, each channel's ``/api/frame`` decoded by
  ``data/image_io.py`` equal to the rendered array and within the render
  tolerances of the JAX ``ViewerState``'s frame, the cache, ``/api/click``,
  the free camera (distinct poses, the cache, the LRU bound of 16 poses),
  training while viewing, ``/api/stop``, unknown paths, and eight clients
  requesting frames while an epoch trains.
- ``main_interactive.main`` with ``--render-views``.
- The sweep: the same stub trial in both packages' ``asha_sweep`` gives
  equal ``sweep_results.json`` (a failed trial included; walls apart); a
  real in-process sweep on the CPU resumes rung 1 from rung 0's checkpoint
  to epoch 2; ``main`` with ``--num-workers 2 --worker-platform cpu`` trains
  each trial in a worker process; a ``cuda`` worker without a card fails
  its trial (no CPU fallback).
- ``python -m pagnerf_tpu_torch.cli --validate-dataset`` exits with 1 on a
  tree with several errors, as ``main.py`` does.
"""
import json
import os
import shutil
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import main_hp_tunning as hp_j
from pagnerf_tpu.app import orbit_renderer as orbit_j
from pagnerf_tpu.app import viewer_server as viewer_j
from pagnerf_tpu_torch import main_hp_tunning as hp_t
from pagnerf_tpu_torch import main_interactive
from pagnerf_tpu_torch.app import orbit_renderer as orbit_t
from pagnerf_tpu_torch.app import viewer_server as viewer_t
from pagnerf_tpu_torch.data.image_io import read_png
from test_torch_validation import _trainer_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "synthetic", "tiny.yaml")
TIE = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops in one thread: beside five busy test workers, torch's
    spinning intra-op threads took a 5 s tiny CLI run to 293 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recording(trainer, renders):
    """Keep each ``batch_render``'s raw channels (as numpy) in ``renders``."""
    render = trainer.batch_render

    def spy(rays, channels, *args, **kwargs):
        rb = render(rays, channels, *args, **kwargs)
        renders.append({k: np.asarray(v.float() if isinstance(v, torch.Tensor) else v)
                        for k in ("semantics", "inst_embedding")
                        if (v := getattr(rb, k)) is not None})
        return rb
    trainer.batch_render = spy


@pytest.fixture(scope="module")
def pair():
    """The JAX and the port trainer of the tiny flagship on the same
    parameters; each records its renders' raw channels."""
    tj, tt = _trainer_pair(epochs=4)
    tt.pipeline.requires_grad_(True)
    raw = {"jax": [], "torch": []}
    _recording(tj, raw["jax"])
    _recording(tt, raw["torch"])
    return tj, tt, raw


def _top2_gap(x):
    s = np.sort(x, axis=-1)
    return s[..., -1] - s[..., -2]


def _assert_images_match(out_t, out_j, raw_j, what):
    assert sorted(out_t) == sorted(out_j), what
    h, w = out_j["rgb"].shape[:2]
    for k in ("rgb", "depth", "semantics", "instance"):
        assert out_t[k].dtype == np.uint8 and out_t[k].shape == out_j[k].shape, (what, k)
    diff = lambda k: np.abs(out_t[k].astype(int) - out_j[k].astype(int))
    assert diff("rgb").max() <= 1, what
    assert diff("depth").max() <= 2, what
    for k, ch in (("semantics", "semantics"), ("instance", "inst_embedding")):
        clear = _top2_gap(raw_j[ch]).reshape(h, w) > TIE
        assert clear.mean() > 0.9, (what, k)
        assert np.array_equal(out_t[k][clear], out_j[k][clear]), (what, k)
    np.testing.assert_allclose(out_t["_inst_embedding"], out_j["_inst_embedding"],
                               rtol=3e-5, atol=3e-6)


@pytest.mark.parametrize("view", [0, 1])
def test_render_channels_for_view_matches_jax(pair, view):
    tj, tt, raw = pair
    out_j = orbit_j.render_channels_for_view(tj, view)
    out_t = orbit_t.render_channels_for_view(tt, view)
    _assert_images_match(out_t, out_j, raw["jax"][-1], f"view {view}")


def test_render_channels_for_pose_matches_jax(pair):
    tj, tt, raw = pair
    c2w = orbit_j.pose_from_orbit(30.0, 20.0, 2.2)
    assert np.array_equal(orbit_t.pose_from_orbit(30.0, 20.0, 2.2), c2w)
    for args in ((0.0, 95.0, 1.5, (0.1, 0.2, 0.3)), (-40.0, -10.0, 3.0)):
        assert np.array_equal(orbit_t.pose_from_orbit(*args), orbit_j.pose_from_orbit(*args))
    out_j = orbit_j.render_channels_for_pose(tj, c2w)
    out_t = orbit_t.render_channels_for_pose(tt, c2w)
    _assert_images_match(out_t, out_j, raw["jax"][-1], "pose")


def test_embedding_distance_image_matches_jax(pair):
    tj, tt, _ = pair
    emb_j = orbit_j.render_channels_for_view(tj, 1)["_inst_embedding"]
    emb_t = orbit_t.render_channels_for_view(tt, 1)["_inst_embedding"]
    for q in ((0, 0), (5, 7), (15, 15)):
        assert np.array_equal(orbit_t.embedding_distance_image(emb_j, q),
                              orbit_j.embedding_distance_image(emb_j, q))
        d = (orbit_t.embedding_distance_image(emb_t, q).astype(int)
             - orbit_j.embedding_distance_image(emb_j, q).astype(int))
        assert np.abs(d).max() <= 1, q


def test_render_orbit_keeps_each_views_png(pair, tmp_path):
    tj, tt, raw = pair
    frames_t = orbit_t.render_orbit(tt, str(tmp_path), views=[1, 3])
    frames_j = orbit_j.render_orbit(tj, str(tmp_path / "jax"), views=[1, 3])
    assert sorted(frames_t) == ["depth", "instance", "rgb", "semantics"]
    assert sorted(os.listdir(tmp_path / "video")) == sorted(
        f"{c}_{i:04d}.png" for c in frames_t for i in range(2))
    for c, fl in frames_t.items():
        assert len(fl) == 2
        for i, view in enumerate((1, 3)):
            assert np.array_equal(read_png(str(tmp_path / f"{c}_{view:04d}.png")), fl[i]), c
            assert np.array_equal(read_png(str(tmp_path / "video" / f"{c}_{i:04d}.png")),
                                  fl[i]), c
        assert not os.path.exists(tmp_path / f"{c}_0000.png")
    for i in range(2):
        _assert_images_match({c: fl[i] for c, fl in frames_t.items()} | {
            "_inst_embedding": orbit_t.render_channels_for_view(tt, (1, 3)[i])[
                "_inst_embedding"]}, {c: fl[i] for c, fl in frames_j.items()} | {
            "_inst_embedding": orbit_j.render_channels_for_view(tj, (1, 3)[i])[
                "_inst_embedding"]}, raw["jax"][-1], f"orbit frame {i}")


# ------------------------------------------------------------------ the viewer
@pytest.fixture(scope="module")
def viewer(pair):
    tj, tt, raw = pair
    server, state = viewer_t.make_server(tt, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", state, viewer_j.ViewerState(tj), raw
    server.shutdown()
    server.server_close()


def _get(url, method="GET"):
    req = urllib.request.Request(url, method=method)
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _png(body, tmp_path, name="frame.png"):
    assert body[:8] == b"\x89PNG\r\n\x1a\n"
    path = tmp_path / name
    path.write_bytes(body)
    return read_png(str(path))


def test_viewer_page_and_info(viewer):
    base, state, state_j, _ = viewer
    code, ctype, body = _get(base + "/")
    assert code == 200 and "text/html" in ctype and b"pagnerf_tpu_torch viewer" in body
    assert body.replace(b"pagnerf_tpu_torch viewer", b"pagnerf_tpu viewer") == \
        viewer_j._PAGE.encode()
    code, ctype, body = _get(base + "/api/info")
    info = json.loads(body)
    assert code == 200 and ctype == "application/json"
    assert info["views"] == state_j.views == [0, 1, 2, 3]
    assert info["channels"] == list(viewer_j.CHANNELS)
    assert (info["epoch"], info["total_epochs"], info["training"], info["losses"]) == (
        state.trainer.epoch, 4, False, {})
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base + "/api/nothing")
    assert e.value.code == 404


def test_viewer_frames_match_jax(viewer, tmp_path):
    base, state, state_j, raw = viewer
    images = {}
    for channel in viewer_t.CHANNELS:
        code, ctype, body = _get(f"{base}/api/frame?view=1&channel={channel}")
        assert code == 200 and ctype == "image/png", channel
        images[channel] = _png(body, tmp_path)
        assert np.array_equal(images[channel], state.frame(1, channel)), channel
        _, _, again = _get(f"{base}/api/frame?view=1&channel={channel}")
        assert again == body, channel                     # the cache
    frames_j = state_j.channels_for_view(1)
    _assert_images_match(images | {"_inst_embedding": state.channels_for_view(1)[
        "_inst_embedding"]}, frames_j, raw["jax"][-1], "viewer frame")
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(f"{base}/api/frame?view=1&channel=nothing")
    assert e.value.code == 404


def test_viewer_click_matches_jax(viewer, tmp_path):
    base, state, state_j, _ = viewer
    code, ctype, body = _get(f"{base}/api/click?view=1&y=5&x=7")
    assert code == 200 and ctype == "image/png"
    img = _png(body, tmp_path)
    assert np.array_equal(img, state.click(1, 5, 7))
    assert np.abs(img.astype(int) - state_j.click(1, 5, 7).astype(int)).max() <= 1
    # a click outside the image is clipped to it, as in the JAX viewer
    assert np.array_equal(state.click(1, 99, -3), state.click(1, 15, 0))


def test_viewer_free_camera(viewer, tmp_path):
    base, state, state_j, raw = viewer
    _, _, body = _get(f"{base}/api/free_frame?az=0&el=20&r=2.2&channel=rgb")
    _, _, body2 = _get(f"{base}/api/free_frame?az=90&el=-10&r=1.5&channel=rgb")
    assert body2 != body
    _, _, body3 = _get(f"{base}/api/free_frame?az=0&el=20&r=2.2&channel=rgb")
    assert body3 == body                                    # the cache
    want = state_j.free_frame(0.0, 20.0, 2.2, "rgb")
    assert np.abs(_png(body, tmp_path).astype(int) - want.astype(int)).max() <= 1
    for az in range(0, 360, 20):                            # 18 more poses
        _get(f"{base}/api/free_frame?az={az}&el=5&r=2&channel=depth")
    free = [k for k in state._cache if isinstance(k, tuple) and k[0] == "free"]
    assert len(free) == state.MAX_FREE_POSES == 16
    assert free[-1] == ("free", 340.0, 5.0, 2.0)


def test_viewer_trains_while_viewing_and_stops(viewer, tmp_path):
    base, state, _, _ = viewer
    before = _png(_get(f"{base}/api/frame?view=1&channel=rgb")[2], tmp_path)
    epoch = state.trainer.epoch
    code, _, body = _get(base + "/api/train?epochs=1", method="POST")
    assert code == 200 and json.loads(body)["started"]
    state._train_thread.join(timeout=600)
    assert not state.training and state.trainer.epoch == epoch + 1
    assert state.last_losses and all(np.isfinite(v) for v in state.last_losses.values())
    info = json.loads(_get(base + "/api/info")[2])
    assert info["epoch"] == epoch + 1 and sorted(info["losses"]) == sorted(state.last_losses)
    after = _png(_get(f"{base}/api/frame?view=1&channel=rgb")[2], tmp_path)
    assert not np.array_equal(before, after)                # the cache was cleared
    # stop: requested while the first of 2 epochs waits for the lock
    with state.lock:
        assert json.loads(_get(base + "/api/train?epochs=2", method="POST")[2])["started"]
        assert not json.loads(_get(base + "/api/train?epochs=2", method="POST")[2])["started"]
        assert json.loads(_get(base + "/api/stop", method="POST")[2]) == {"stopping": True}
    state._train_thread.join(timeout=600)
    assert not state.training and state.trainer.epoch in (epoch + 1, epoch + 2)


def test_viewer_serves_frames_while_it_trains(viewer, tmp_path):
    """Eight threads request frames of every view and the free camera while
    an epoch trains (the switch interval shortened): every request gets a
    PNG of the view's shape and the epoch ends."""
    base, state, _, _ = viewer
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    errors, epoch = [], state.trainer.epoch
    shape = tuple(state.trainer.dataset.img_shape)

    def client(i):
        try:
            for k in range(6):
                path = (f"/api/frame?view={(i + k) % 4}&channel=rgb" if k % 3 else
                        f"/api/free_frame?az={20 * i}&el=10&r=2&channel=depth")
                code, ctype, body = _get(base + path)
                img = _png(body, tmp_path, f"f{i}_{k}.png")
                if code != 200 or ctype != "image/png" or img.shape[:2] != shape:
                    errors.append((path, code, ctype, img.shape))
        except Exception as e:      # noqa: BLE001 -- reported below
            errors.append(repr(e))

    try:
        assert json.loads(_get(base + "/api/train?epochs=1", method="POST")[2])["started"]
        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads + [state._train_thread]:
            t.join(timeout=600)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not state.training
    assert not errors, errors[:3]
    assert state.trainer.epoch == epoch + 1


def test_main_interactive_renders_views(tmp_path):
    frames = main_interactive.main(["--config", TINY, "--device", "cpu", "--log-dir",
                                    str(tmp_path / "logs"), "--render-views",
                                    "--render-views-dir", str(tmp_path / "views")])
    n = len(frames["rgb"])
    assert n >= 2 and len(list((tmp_path / "views").glob("rgb_*.png"))) == n


# ------------------------------------------------------------------- the sweep
def _stub(base_args, overrides, epochs, out_dir, trial_id, resume_from=None):
    """A deterministic trial: fails for lr 1e-3 with hidden 32."""
    if overrides["lr"] == 1e-3 and overrides["hidden_dim"] == 32:
        raise RuntimeError("simulated device loss")
    score = 10 * overrides["lr"] * overrides["hidden_dim"] + epochs
    return {"val/psnr": score, "val/iou": epochs / 10, "_ckpt": os.path.join(
        out_dir, f"{trial_id}.ckpt"), "resumed": resume_from}


def test_sweep_results_equal_jax_under_a_stub_trial(tmp_path, monkeypatch):
    space = {"lr": [1e-3, 5e-3], "hidden_dim": [32, 64], "sem_weight": [0.1, 1.0]}
    out = {}
    for name, hp in (("jax", hp_j), ("torch", hp_t)):
        monkeypatch.setattr(hp, "run_trial", _stub)
        hp.asha_sweep(["--config", TINY], space, str(tmp_path / name), rung_epochs=2,
                      num_rungs=3)
        with open(tmp_path / name / "sweep_results.json") as f:
            out[name] = [{k: v for k, v in r.items() if k != "wall"} for r in json.load(f)]
    assert out["torch"] == [dict(r, metrics={k: (v.replace(str(tmp_path / "jax"),
                                                            str(tmp_path / "torch"))
                                                  if isinstance(v, str) else v)
                                              for k, v in r["metrics"].items()})
                            for r in out["jax"]]
    assert [r["rung"] for r in out["torch"]] == [0] * 8 + [1] * 4 + [2] * 2
    assert sum(r["metric"] is None for r in out["torch"]) == 2
    assert {r["metrics"]["_failed"] for r in out["torch"] if r["metric"] is None} == {
        "simulated device loss"}


def test_sweep_rungs_continue_training_on_the_cpu(tmp_path):
    base = ["--config", TINY, "--log-dir", str(tmp_path), "--valid-every", "-1",
            "--device", "cpu"]
    results = hp_t.asha_sweep(base, {"lr": [5e-3]}, str(tmp_path), rung_epochs=1,
                              num_rungs=2)
    assert [(r["trial"], r["rung"]) for r in results] == [("trial_000", 0), ("trial_000", 1)]
    assert all(r["metric"] > 0 for r in results)
    state = torch.load(tmp_path / "trial_000.ckpt", weights_only=True)
    assert state["epoch"] == 2 and state["global_step"] > 0
    with open(tmp_path / "sweep_results.json") as f:
        assert len(json.load(f)) == 2


def test_sweep_workers_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # the workers' torch threads
    results = hp_t.main(["--config", TINY, "--out-dir", str(tmp_path), "--space",
                         '{"lr": [0.005, 0.001]}', "--rung-epochs", "1", "--num-rungs", "1",
                         "--num-workers", "2", "--worker-platform", "cpu", "--device", "cuda"])
    assert len(results) == 2
    for r in results:
        assert r["metric"] is not None and "val/psnr" in r["metrics"], r
        assert os.path.exists(tmp_path / f"{r['trial']}.ckpt")
        with open(tmp_path / f"{r['trial']}_epoch1.worker.json") as f:
            stats = json.load(f)
        assert stats["device"] == "cpu" and stats["wall_s"] > 0
        assert (stats["resumed_epoch"], stats["epoch"]) == (0, 1)
        assert stats["launches"]["encode"] == 0         # the CPU counts no launch


def test_cuda_worker_without_a_card_fails_its_trial(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hp_t.worker_device({"platform": None, "slot": 0,
                            "base_args": ["--config", TINY, "--device", "cuda"]})
    assert hp_t.worker_device({"platform": "cpu", "slot": 1, "base_args": []}) == "cpu"
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    base = ["--config", TINY, "--log-dir", str(tmp_path), "--device", "cpu"]
    results = hp_t.asha_sweep(base, {"lr": [5e-3]}, str(tmp_path), rung_epochs=1,
                              num_rungs=1, num_workers=2, worker_platform="cuda")
    assert results[0]["metric"] is None
    assert "no CUDA device" in results[0]["metrics"]["_failed"]
    assert not os.path.exists(tmp_path / "trial_000.ckpt")


# ------------------------------------------------------------- the exit code
def test_validate_dataset_exits_with_one_on_errors(tmp_path):
    """Several errors: the count is returned, and the command exits with 1."""
    from pagnerf_tpu_torch import cli
    from pagnerf_tpu_torch.data.bup20_tree import write_bup20_tree
    tree = tmp_path / "BUP_20"
    write_bup20_tree(str(tree), width=16, height=9, supersample=1)
    seq = sorted(p for p in tree.rglob("depth") if p.is_dir())[0].parent
    for f in sorted((seq / "depth").iterdir())[3:6]:
        f.unlink()
    (seq / "params.yaml").write_text("intrinsics: [[1.0, 0.0], [0.0, 1.0]]\n"
                                     "extrinsics: oops\n")
    argv = ["--config", os.path.join(ROOT, "configs", "bup20", "best.yaml"),
            "--dataset-path", str(tree), "--validate-dataset"]
    assert cli.main(argv) >= 2
    proc = subprocess.run([sys.executable, "-m", "pagnerf_tpu_torch.cli", *argv],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr[-2000:]
    shutil.rmtree(tree)
    write_bup20_tree(str(tree), width=16, height=9, supersample=1)
    assert subprocess.run([sys.executable, "-m", "pagnerf_tpu_torch.cli", *argv], cwd=ROOT,
                          capture_output=True, timeout=300).returncode == 0
