"""The port's config path against the JAX package's, on the CPU.

- ``yaml_lite.load`` gives ``yaml.safe_load``'s value on every file under
  ``configs/``, and raises on YAML outside its subset.
- ``parse_options`` gives the JAX package's ``vars(args)`` for every YAML
  there, with and without command-line overrides; the config snapshot
  (``config_to_yaml``) parses back to the same namespace.
- For every ``configs/synthetic/*.yaml`` the factory's trainer, optimizer,
  tracer and grid configs equal the JAX factory's field for field (the JAX
  factory is run with its dataset and trainer stubbed, so nothing is built),
  and the dataset arrays are bit-identical.
- What the port does not have raises ``NotImplementedError``; every YAML
  under ``configs/`` builds and passes ``stage_for_epoch`` at every epoch.
"""
import argparse
import dataclasses
import glob
import json
import os
import types

import numpy as np
import pytest
import torch
import yaml

from pagnerf_tpu.config import config as config_j
from pagnerf_tpu.config import factory as factory_j
from pagnerf_tpu_torch.config import config as config_t
from pagnerf_tpu_torch.config import factory as factory_t
from pagnerf_tpu_torch.config import yaml_lite

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))
SYNTHETIC = [p for p in CONFIGS if "/synthetic/" in p]
OVERRIDES = ["--epochs", "3", "--lr", "0.01", "--synthetic-res", "16", "12",
             "--lod-anneling", "--use-lr-scheduler", "false", "--load-modes", "imgs",
             "preds_x", "--camera-origin", "1", "2", "3", "--exp-name", "x"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops in one thread: beside five busy test workers, torch's
    spinning intra-op threads took a 5 s tiny CLI run to 293 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_configs_found():
    assert len(CONFIGS) >= 26 and len(SYNTHETIC) >= 11


@pytest.mark.parametrize("path", CONFIGS)
def test_yaml_reader_matches_pyyaml(path):
    with open(os.path.join(ROOT, path)) as f:
        text = f.read()
    assert yaml_lite.load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "k: 1e-4", "k: 1.0e-4", "k: 0x1F", "k: 017", "k: 0b101", "k: +5", "k: -.inf",
    "k: yes", "k: Off", "k: ~", "k:", "k: 1_000", "k: 'true'", "k: ''", "k: 'it''s'",
    'k: "a\\"b"', "k: [a, 'b, c', 1.5, null]", "k: []", "k: [1,]", "a:\n  b:\n    c: 1\n  d: x",
    "# only a comment\nk: v  # trailing", "k: a#b", "k: [[1]]", "k:\n  - 1"])
def test_yaml_scalars_resolve_as_pyyaml(text):
    got, want = yaml_lite.load(text), yaml.safe_load(text)
    assert got == want and [type(v) for v in got.values()] == [type(v) for v in want.values()]


@pytest.mark.parametrize("text", [
    "k: &a 1", "k: !!str 1", "k: a: b", "k: 1:30",
    "k: 2020-01-01", "---\nk: 1", "k: |\n  x", "k: {a: 1}", "k: v\n    w", "\tk: 1",
    "k: [1, [2]x]", "k: [1,,2]", "k: [[1]", "a: 1\n- 2", "- a\n  b", "k:\n  - 1\n   - 2"])
def test_yaml_outside_the_subset_raises(text):
    with pytest.raises(yaml_lite.YamlLiteError):
        yaml_lite.load(text)


def test_yaml_writer_round_trips():
    value = {"g": {"s": "1e-4", "t": "true", "e": "", "f": 1e-5, "n": None,
                   "l": ["a", 1, 2.5], "z": [], "m": "a:b", "h": "#x", "neg": "-x",
                   "inf": float("inf"), "b": False}}
    text = yaml_lite.dump(value)
    assert yaml_lite.load(text) == value == yaml.safe_load(text)


def test_yaml_lite_never_uses_pyyaml():
    with open(yaml_lite.__file__) as f:
        assert "import yaml" not in f.read()


@pytest.mark.parametrize("overrides", [[], OVERRIDES], ids=["yaml", "overrides"])
@pytest.mark.parametrize("path", CONFIGS)
def test_parser_namespace_matches_jax(path, overrides):
    argv = ["--config", os.path.join(ROOT, path)] + overrides
    assert vars(config_t.parse_options(argv)) == vars(config_j.parse_options(argv))


def test_flag_table_is_the_jax_one():
    assert config_t.FLAG_GROUPS == config_j.FLAG_GROUPS


@pytest.mark.parametrize("path", SYNTHETIC)
def test_config_snapshot_parses_back(path, tmp_path):
    args = config_t.parse_options(["--config", os.path.join(ROOT, path)] + OVERRIDES)
    snap = tmp_path / "config.yaml"
    snap.write_text(config_t.config_to_yaml(config_t.build_parser(), args))
    again = config_t.parse_options(["--config", str(snap)])
    drop = ("config", "help")
    assert ({k: v for k, v in vars(again).items() if k not in drop}
            == {k: v for k, v in vars(args).items() if k not in drop})
    # the snapshot is YAML that PyYAML reads to the same values
    assert yaml.safe_load(snap.read_text()) == yaml_lite.load(snap.read_text())


def test_unknown_field_and_deep_parent_raise(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("trainer:\n  epochz: 3\n")
    with pytest.raises(ValueError, match="not a valid option"):
        config_t.parse_options(["--config", str(bad)])
    (tmp_path / "a.yaml").write_text("parent: b.yaml\n")
    (tmp_path / "b.yaml").write_text("parent: c.yaml\n")
    (tmp_path / "c.yaml").write_text("trainer:\n  epochs: 3\n")
    with pytest.raises(Exception, match="more than 1 level"):
        config_t.parse_options(["--config", str(tmp_path / "a.yaml")])


# ------------------------------------------------------------------ factory
def _jax_factory_configs(args):
    """The configs the JAX factory builds from ``args``, with its dataset
    and trainer stubbed (no data made, no parameters initialised)."""
    seen = {}
    ds = types.SimpleNamespace(
        semantic_info={"num_classes": 3, "num_instances": 6},
        data={"view_matrices": np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))})

    def trainer(pipeline, dataset, cfg, opt_cfg, occ_level):
        seen.update(pipeline=pipeline, cfg=cfg, opt_cfg=opt_cfg, occ_level=occ_level)
        return types.SimpleNamespace(timer=types.SimpleNamespace(activate=False))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(factory_j, "load_dataset", lambda a: ds)
        mp.setattr(factory_j, "PanopticTrainer", trainer)
        factory_j.get_modules_from_config(args)
    return seen


@pytest.mark.parametrize("path", SYNTHETIC)
def test_factory_configs_match_jax(path):
    args = config_t.parse_options(["--config", os.path.join(ROOT, path)])
    j = _jax_factory_configs(config_j.parse_options(["--config", os.path.join(ROOT, path)]))
    assert dataclasses.asdict(factory_t.trainer_config_from_args(args)) == \
        dataclasses.asdict(j["cfg"])
    assert dataclasses.asdict(factory_t.optimizer_config_from_args(args)) == \
        dataclasses.asdict(j["opt_cfg"])
    assert dataclasses.asdict(factory_t.tracer_config_from_args(args)) == \
        dataclasses.asdict(j["pipeline"].tracer_cfg)
    assert args.blas_level == j["occ_level"]
    nef_j = j["pipeline"].nef
    for delta, grid_j in ((False, nef_j.grid), (True, nef_j.delta_grid)):
        grid_t = dataclasses.asdict(factory_t.grid_config_from_args(args, delta))
        grid_t["compute_dtype"] = {torch.float32: "float32",
                                   torch.bfloat16: "bfloat16"}[grid_t["compute_dtype"]]
        assert grid_t == {k: v for k, v in dataclasses.asdict(grid_j).items()
                          if k in grid_t}
    assert type(j["pipeline"]).__name__ == "BAPipeline"


_DATASETS = {}


def _dataset_pair(path):
    args_t = config_t.parse_options(["--config", os.path.join(ROOT, path)])
    key = (args_t.synthetic_num_views, tuple(args_t.synthetic_res),
           args_t.synthetic_num_spheres, args_t.synthetic_preds)
    if key not in _DATASETS:
        args_j = config_j.parse_options(["--config", os.path.join(ROOT, path)])
        _DATASETS[key] = (factory_t.load_dataset(args_t), factory_j.load_dataset(args_j))
    return _DATASETS[key]


@pytest.mark.parametrize("path", SYNTHETIC)
def test_factory_dataset_bit_identical(path):
    ds_t, ds_j = _dataset_pair(path)
    arrays = {k for k, v in ds_j.data.items() if isinstance(v, np.ndarray)}
    assert arrays == {k for k, v in ds_t.data.items() if isinstance(v, np.ndarray)}
    for k in sorted(arrays):
        assert ds_t.data[k].dtype == ds_j.data[k].dtype, k
        np.testing.assert_array_equal(ds_t.data[k], ds_j.data[k], err_msg=k)
    assert ds_t.data["semantic_info"] == ds_j.data["semantic_info"]
    np.testing.assert_array_equal(ds_t.train_idxs, ds_j.train_idxs)


def test_factory_builds_the_tiny_config_on_cpu():
    args = config_t.parse_options(["--config", os.path.join(ROOT, "configs/synthetic/tiny.yaml"),
                                   "--perf"])
    pipe, ds, trainer = factory_t.get_modules_from_config(args, "cpu", seed=3)
    assert type(pipe).__name__ == "BAPipeline" and trainer.cfg.seed == 3
    assert trainer.timer.activate and trainer.occ.level == args.blas_level
    assert all(p.requires_grad and p.device.type == "cpu" for p in pipe.parameters())
    assert pipe.nef.grid_cfg.num_lods == 6 and pipe.nef.delta_grid.spec.num_levels == 6


# ------------------------------------------------------------------ refusals
def _args(*extra):
    return config_t.parse_options(
        ["--config", os.path.join(ROOT, "configs/synthetic/tiny.yaml"), *extra])


# the ROADMAP.md Queue 1 item that ports each; a format neither package
# reads names none; "ported": the factory builds it since
_ITEM = {"replica": None, "PanopticDDensityNeF": "ported",
         "MeanShiftPanopticDeltaNeF": "ported", "SemanticNeF": "ported",
         "HashGrid": "ported"}


@pytest.mark.parametrize("extra, what", [
    (("--multiview-dataset-format", "replica"), "dataset format"),
    (("--nef-type", "PanopticDDensityNeF"), "nef_type"),
    (("--nef-type", "MeanShiftPanopticDeltaNeF"), "nef_type"),
    (("--nef-type", "SemanticNeF"), "nef_type"),
    (("--grid-type", "HashGrid"), "grid_type"),
])
def test_factory_refuses_what_is_not_ported(extra, what):
    """The factory refuses what the port does not have, naming its item,
    and builds what it has (the DD and mean-shift NeFs since their slice,
    the baselines and the hash grid since the next)."""
    item = _ITEM[extra[1]]
    if item == "ported":
        pipe, _, _ = factory_t.get_modules_from_config(_args(*extra), "cpu")
        built = pipe.nef.grid if what == "grid_type" else pipe.nef
        assert type(built).__name__ == extra[1]
        return
    match = (f"{what}.*ROADMAP.md Queue 1 item {item}\\b" if item
             else f"{what} .* is not supported")
    with pytest.raises(NotImplementedError, match=match):
        factory_t.get_modules_from_config(_args(*extra), "cpu")


@pytest.mark.parametrize("extra", [("--grid-tvl1-reg", "0.1"), ("--fused-micro-step",),
                                   ("--inst-loss", "sup_contrastive")])
def test_trainer_still_refuses_unported_stages(extra):
    """Nothing is refused since the fused micro-step is ported (the name is
    kept): the TV regularisers and the contrastive loss build their stage,
    and ``--fused-micro-step`` trains through the fused step."""
    _, _, trainer = factory_t.get_modules_from_config(_args(*extra), "cpu")
    epoch = trainer.cfg.inst_epoch_start
    stage = trainer.stage_for_epoch(epoch)
    assert stage.use_inst
    if extra[0] == "--fused-micro-step":
        assert trainer.cfg.fused_micro_step and trainer._fused_step_enabled()
        batch = trainer.dataset.sample_batch(np.random.default_rng(0), trainer.cfg.batch_size,
                                             trainer.cfg.num_rays_sampled_per_img)
        losses = trainer.train_step(stage, batch)
        assert np.isfinite(float(losses["total_loss"])) and len(trainer._fused) == 1


@pytest.mark.parametrize("extra", [("--optimizer-type", "sgd"), ("--weight-decay", "0.1")])
def test_optimizer_still_refuses_other_optimizers(extra):
    """Nothing is refused since the other optimizers and weight decay are
    ported (the name is kept): the factory builds the optimizer the flags
    name, SGD, or Adam with the grid groups' decay (``adamw``)."""
    _, _, trainer = factory_t.get_modules_from_config(_args(*extra), "cpu")
    opt = trainer.opt
    if extra[0] == "--optimizer-type":
        assert (opt.cfg.optimizer_type, opt.kind, opt.mu, opt.nu) == ("sgd", "sgd", {}, {})
        assert sorted(opt.state()) == ["count", "kind"]
    else:
        assert (opt.cfg.weight_decay, opt.kind) == (0.1, "adamw")
        assert opt._decay("grid") == opt._decay("delta_grid") == 0.1
        assert opt._decay("decoder") == opt._decay("extrinsics") == 0.0
        assert set(opt.mu) == set(opt.nu) == set(trainer.params)


def test_argparse_namespace_type():
    assert isinstance(_args(), argparse.Namespace)


# ------------------------------------------------------------------ every config
# What each config is refused at, first, with the ROADMAP.md Queue 1 item
# that ports it; every other config builds and every epoch's stage passes.
# Since the hash, triplanar and TensoRF grids and the baseline NeFs are
# ported, none is refused.
FIRST_REFUSAL = {}
# the model's width cut for the CPU (which parts are ported does not depend on it)
SHRINK = ["--num-lods", "4", "--capacity-log-2", "8", "--delta-capacity-log-2", "8",
          "--codebook-bitwidth", "8"]


@pytest.fixture(scope="module")
def tiny_trees(tmp_path_factory):
    """A 16x9 BUP20 tree and a 16x12 NeRF-standard tree of 4 RGBA frames."""
    from pagnerf_tpu_torch.data.bup20_tree import write_bup20_tree
    from pagnerf_tpu_torch.utils.visualization import write_png
    bup20 = tmp_path_factory.mktemp("tiny") / "BUP_20"
    write_bup20_tree(str(bup20), width=16, height=9, supersample=1)
    nerf = tmp_path_factory.mktemp("nerf")
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        frames = []
        for i in range(2):
            write_png(str(nerf / f"{split}_{i}.png"),
                      rng.integers(0, 256, (12, 16, 4)).astype(np.uint8))
            c2w = np.eye(4)
            c2w[:3, 3] = [0.1 * i, 0.0, 1.0]
            frames.append({"file_path": f"{split}_{i}", "transform_matrix": c2w.tolist()})
        (nerf / f"transforms_{split}.json").write_text(
            json.dumps({"camera_angle_x": 0.8, "frames": frames}))
    return {"bup20": bup20, "standard": nerf}


def _tiny_argv(path, trees):
    fmt = config_t.parse_options(["--config", os.path.join(ROOT, path)]).multiview_dataset_format
    if fmt == "bup20":
        return ["--dataset-path", str(trees["bup20"]), "--dataset-center-idx", "0",
                "--load-modes", "imgs", "semantics", "instance", "preds_mask2former"]
    if fmt == "standard":
        return ["--dataset-path", str(trees["standard"])]
    return ["--synthetic-res", "16", "12", "--synthetic-num-views", "4"]


@pytest.mark.parametrize("path", CONFIGS)
def test_every_config_builds_or_names_its_first_unported_part(path, tiny_trees,
                                                             monkeypatch):
    """The factory with the dataset swapped for a tiny one of the config's
    format (the config's own dataset settings otherwise), then
    ``stage_for_epoch`` at every epoch of the config."""
    args = config_t.parse_options(["--config", os.path.join(ROOT, path)] + SHRINK)
    tiny = factory_t.load_dataset(config_t.parse_options(
        ["--config", os.path.join(ROOT, path)] + _tiny_argv(path, tiny_trees)))
    monkeypatch.setattr(factory_t, "load_dataset", lambda a: tiny)

    def run():
        _, _, trainer = factory_t.get_modules_from_config(args, "cpu")
        for epoch in range(args.epochs):
            trainer.stage_for_epoch(epoch)

    if path in FIRST_REFUSAL:
        with pytest.raises(NotImplementedError, match=FIRST_REFUSAL[path]):
            run()
    else:
        run()


@pytest.mark.parametrize("path", CONFIGS)
def test_no_config_is_refused_at_its_dataset_format(path, tiny_trees):
    args = config_t.parse_options(["--config", os.path.join(ROOT, path)]
                                  + _tiny_argv(path, tiny_trees))
    ds = factory_t.load_dataset(args)
    assert ds.num_train > 0 and ds.data["imgs"].shape[1:3] in ((9, 16), (12, 16))
    if args.multiview_dataset_format == "bup20":
        assert "semantics_pred" in ds.data and len(ds.val_idxs) == 40


def test_config_hp_base_first_panoptic_step_raises_as_jax(tiny_trees):
    """``config_hp_base.yaml`` puts the DD tracer over a ``PanopticDeltaNeF``,
    which has no ``panoptic_density``: with labels, the first panoptic step
    (epoch 0) raises ``KeyError`` in the JAX package, and in the port at
    the same call."""
    argv = ["--config", os.path.join(ROOT, "configs/bup20/config_hp_base.yaml")] + SHRINK \
        + _tiny_argv("configs/bup20/config_hp_base.yaml", tiny_trees) \
        + ["--num-rays-sampled-per-img", "8", "--num-steps", "8", "--batch-size", "2"]
    _, _, trainer_j = factory_j.get_modules_from_config(config_j.parse_options(argv))
    _, _, trainer_t = factory_t.get_modules_from_config(config_t.parse_options(argv), "cpu")
    for trainer in (trainer_j, trainer_t):
        assert trainer.stage_for_epoch(0).use_inst
        with pytest.raises(KeyError, match="panoptic_density"):
            trainer.run_epoch(0)
