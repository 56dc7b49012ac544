"""Config system: argparse flag groups, YAML defaults and a class registry
(counterpart of ``pagnerf_tpu/config/config.py``).

The flag table is the JAX package's, flag for flag (names, types, defaults,
choices), so one YAML and one command line give the same namespace on both
sides. A YAML file sets the parser's *defaults* and the command line still
overrides them; one level of ``parent:`` inheritance, resolved against the
child's directory; unknown fields are rejected. YAML is read and written by
``yaml_lite`` (the card's machine has no PyYAML).
"""
from __future__ import annotations

import argparse
import logging
import os
import pprint
from typing import Any, Dict

from . import yaml_lite

log = logging.getLogger(__name__)

# string -> class registry (reference config_parser.py:29-32)
str2mod: Dict[str, Any] = {}


def register_class(cls, name: str):
    str2mod[name] = cls


def get_registered(name: str):
    if name not in str2mod:
        raise KeyError(f"'{name}' is not registered (known: {sorted(str2mod)})")
    return str2mod[name]


def _str2bool(v):
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("yes", "true", "t", "1")


# (flag, type, default, choices, nargs) per group — names/defaults match the
# reference parser (config_parser.py:51-549; extracted verbatim).
B = "bool"
FLAG_GROUPS: Dict[str, list] = {
    "global": [
        ("trainer-type", str, None, None, None),
        ("exp-name", str, None, None, None),
        ("perf", B, False, None, None),
        ("detect-anomaly", B, False, None, None),
        ("config", str, None, None, None),
        ("default-channel", str, None, None, None),
        ("save-map-only", B, False, None, None),
        # Dataset dry-run: walk the on-disk tree and report schema mismatches
        # without training (data/validate.py) — fail fast on first contact
        # with the real 70 GB BUP20 download. No reference counterpart.
        ("validate-dataset", B, False, None, None),
        ("validate-dataset-deep", B, False, None, None),
    ],
    "grid": [
        ("grid-type", str, "OctreeGrid", None, None),
        ("interpolation-type", str, "linear", ["linear", "closest"], None),
        ("as-type", str, "none", ["none", "octree"], None),
        ("raymarch-type", str, "voxel", ["voxel", "ray"], None),
        ("multiscale-type", str, "sum", ["cat", "sum"], None),
        ("feature-dim", int, 32, None, None),
        ("feature-std", float, 0.0, None, None),
        ("feature-bias", float, 0.0, None, None),
        ("noise-std", float, 0.0, None, None),
        ("num-lods", int, 1, None, None),
        ("base-lod", int, 2, None, None),
        ("max-grid-res", int, 2048, None, None),
        ("tree-type", str, "quad", ["quad", "geometric"], None),
        ("codebook-bitwidth", int, 8, None, None),
        ("coarsest-scale", float, 1.0, None, None),
        ("finest-scale", float, 0.0001, None, None),
        ("capacity-log-2", int, 18, None, None),
        ("delta-capacity-log-2", int, 18, None, None),
        # occupancy-structure resolution: res = 2^blas_level cells per axis
        # (reference OctreeAS BLAS level, grids/occtree.py:35, default 7 ->
        # 128^3). Finer cells hug surfaces, so the occupied FRACTION — which
        # sets every compaction/packing budget — drops with level on
        # surface-dominated scenes.
        ("blas-level", int, 7, None, None),
    ],
    "embedder": [
        ("embedder-type", str, "none", ["none", "positional", "fourier"], None),
        ("pos-multires", int, 10, None, None),
        ("view-multires", int, 4, None, None),
    ],
    "net": [
        ("nef-type", str, None, None, None),
        # bf16 compute (grids + decoder MLPs) — the TPU equivalent of the
        # reference's AMP autocast+GradScaler training (reference
        # pc_nerf/trainer.py:429,582-584; grids/permuto_grid.py:65). Master
        # params, losses and channel outputs stay fp32.
        ("compute-dtype", str, "float32", ["float32", "bfloat16"], None),
        ("layer-type", str, "none", None, None),
        ("activation-type", str, "relu", None, None),
        ("decoder-type", str, "basic", ["none", "basic"], None),
        ("num-layers", int, 1, None, None),
        ("hidden-dim", int, 128, None, None),
        ("out-dim", int, 1, None, None),
        ("skip", int, None, None, None),
        ("pretrained", str, None, None, None),
        ("position-input", B, False, None, None),
        ("num-classes", int, -1, None, None),
        ("num-instances", int, -1, None, None),
        ("sem-activation-type", str, None, None, None),
        ("sem-num-layers", int, None, None, None),
        ("sem-hidden-dim", int, None, None, None),
        ("sem-detach", B, True, None, None),
        ("sem-sigmoid", B, False, None, None),
        ("sem-softmax", B, False, None, None),
        ("sem-normalize", B, False, None, None),
        ("contrast-sem-weight", float, 0.0, None, None),
        ("sem-conf-enable", B, False, None, None),
        ("sem-temperature", float, 1.0, None, None),
        ("sem-epoch-start", int, 0, None, None),
        ("sem-cascade", B, False, None, None),
        ("panoptic-features-type", str, None,
         ["position", "pos_encoding", "appearance", "delta", "separate"], None),
        ("inst-num-layers", int, None, None, None),
        ("inst-hidden-dim", int, None, None, None),
        ("inst-detach", B, True, None, None),
        ("inst-sigmoid", B, False, None, None),
        ("inst-softmax", B, False, None, None),
        ("inst-direct-pos", B, False, None, None),
        ("separate-sem-grid", B, False, None, None),
        ("no-delta-grid", B, False, None, None),
        # Parsed for config-schema parity but intentionally unused: the flag is
        # dead in the reference too (declared at config_parser.py:212-213, stored
        # at pc_nerf/trainer.py:100, never read afterwards).
        ("inst-conf-bootstrap-epoch-start", int, -1, None, None),
        # Zero-init the semantic head's output layer so rendered class
        # probabilities start UNIFORM. With sem_softmax the loss is
        # -log(rendered_prob + 1e-27) (reference pc_nerf/trainer.py:459); a
        # randomly-initialised head decoding TRAINED base features starts
        # confidently wrong (measured: normalized entropy 0.72 vs uniform 1.10
        # at flagship capacity), and the unbounded log slope at p -> 0
        # destabilised the phase start. No reference counterpart (init choice,
        # not behaviour); harmless where random init also worked.
        ("sem-zero-init", B, True, None, None),
        # Composite residual transmittance into slot 0 of the panoptic
        # channels (semantics class 0 = stuff/background; instance slot 0 is
        # reserved for stuff, reference loss/lin_assignment_things.py:23-28).
        # On data where every pixel has geometry (BUP20: alpha ~= 1) this is
        # a no-op; on scenes with true empty space it gives empty rays a
        # correct background prediction instead of p = 0, whose
        # -log(p + 1e-27) slope is unbounded (observed: flagship synthetic
        # run's sem/inst divergence from the first panoptic epoch).
        ("panoptic-bg-residual", B, False, None, None),
    ],
    "dataset": [
        ("dataset-type", str, None, ["sdf", "multiview"], None),
        ("dataset-path", str, None, None, None),
        ("dataset-num-workers", int, -1, None, None),
        ("load-modes", str, [], None, "+"),
        ("scale", float, None, None, "*"),
        ("offset", float, None, None, "*"),
        ("pose-src", str, "odom", ["odom", "metashape"], None),
        # per-sequence robot self-occlusion mask, relative to the sequence dir's
        # parent (reference agrobot_base.py:120-155 mask_robot_path ctor arg)
        ("mask-robot-path", str, None, None, None),
        ("dataset-mode", str, "label_window",
         ["label_window", "all_frames_window"], None),
        ("max-depth", float, -1.0, None, None),
        ("class-labels", str, [], None, "+"),
        ("sample-mode", str, ["rand", "near", "near", "trace", "trace"], None, "*"),
        ("get-normals", B, False, None, None),
        ("num-samples", int, 100000, None, None),
        ("num-samples-on-mesh", int, 100000000, None, None),
        ("sample-tex", B, False, None, None),
        ("mode-mesh-norm", str, "sphere", ["sphere", "aabb", "planar", "none"], None),
        ("samples-per-voxel", int, 256, None, None),
        ("voxel-raymarch-epoch-start", int, -1, None, None),
        ("multiview-dataset-format", str, "standard", None, None),
        # synthetic-scene size knobs (test/convergence scenes only; no reference
        # counterpart — the reference has no synthetic dataset at all)
        ("synthetic-num-views", int, 8, None, None),
        ("synthetic-res", int, [40, 30], None, 2),
        ("synthetic-num-spheres", int, 4, None, None),
        # train from noisy per-frame Mask2Former-like predictions instead of GT
        # labels (the reference's actual regime: train.sh load_modes preds);
        # also enabled when load-modes names a preds source
        ("synthetic-preds", B, False, None, None),
        ("num-rays-sampled-per-img", int, 4096, None, None),
        ("bg-color", str, "white", ["white", "black"], None),
        ("mip", int, None, None, None),
        ("val-mip", int, None, None, None),
        ("model-rescaling", str, "snap_to_bottom",
         ["snap_to_bottom", "scale_to_fit", "largest"], None),
        ("add-noise-to-train-poses", B, False, None, None),
        ("pose-noise-strength", float, 0.01, None, None),
        ("dataset-center-idx", int, 0, None, None),
    ],
    "optimizer": [
        ("optimizer-type", str, "adam", None, None),
        ("lr", float, 0.001, None, None),
        ("extrinsics-lr", float, -1.0, None, None),
        ("use-lr-scheduler", B, False, None, None),
        ("lr-scheduler-type", str, "step",
         ["panoptic_step", "step", "one_cycle"], None),
        ("lr-step-size", int, 0, None, None),
        ("lr-step-gamma", float, 0.1, None, None),
        ("weight-decay", float, 0.0, None, None),
        ("clip-grad-norm", float, 0.0, None, None),
        ("grid-lr-weight", float, 100.0, None, None),
        ("delta-grid-lr-weight", float, 100.0, None, None),
        ("rgb-weight", float, 1.0, None, None),
        ("lr-warmup-epochs", int, 1, None, None),
        ("lr-div-factor", float, 1.0, None, None),
        ("sem-weight", float, 1.0, None, None),
        ("inst-weight", float, 0.01, None, None),
        ("inst-outlier-rejection", B, False, None, None),
        ("grid-tvl1-reg", float, 0.0, None, None),
        ("grid-tvl2-reg", float, 0.0, None, None),
        ("delta-grid-tvl1-reg", float, 0.0, None, None),
        ("delta-grid-tvl2-reg", float, 0.0, None, None),
        ("tv-window-size", float, 0.0, None, None),
        ("tv-edge-num-samples", int, 0, None, None),
        ("ray-sparcity-reg", float, 0.0, None, None),
    ],
    "trainer": [
        ("epochs", int, 250, None, None),
        ("batch-size", int, 512, None, None),
        ("resample", B, False, None, None),
        ("only-last", B, False, None, None),
        ("resample-every", int, 1, None, None),
        ("model-format", str, "full",
         ["full", "params_only", "state_dict", "params_only_ignore_missmatch"], None),
        ("save-as-new", B, False, None, None),
        ("save-every", int, 5, None, None),
        ("render-every", int, 5, None, None),
        ("render-val-labels", B, False, None, None),
        ("save-grid", B, False, None, None),
        ("save-preds", B, False, None, None),
        ("log-2d", B, False, None, None),
        ("log-dir", str, "_results/logs/runs/", None, None),
        ("grow-every", int, -1, None, None),
        ("prune-every", int, -1, None, None),
        ("prune-at-epoch", int, -1, None, None),
        ("prune-at-start", B, False, None, None),
        # early conservative occupancy seeding (TPU-native: recovers the packed
        # reference layout's epoch-0 empty-space skipping; see trainer.prune)
        ("seed-prune-epoch", int, -1, None, None),
        ("seed-keep-frac", float, 0.2, None, None),
        # refresh the seeded occupancy every N epochs until the real prune
        # (tracks the converging field like the reference's every-few-steps
        # occupancy updates; TrainerConfig.seed_refresh_every)
        ("seed-refresh-every", int, 0, None, None),
        ("seed-refresh-keep-frac", float, 0.02, None, None),
        # shrink-only prune masks (reference kaolin-SPC octrees only remove
        # cells; free revival re-admits density-drifted dead regions)
        ("prune-monotone", B, True, None, None),
        # cross-ray packed sample layout after the prune (TrainerConfig.
        # packed_compaction; ops/packed.py) — the TPU equivalent of the
        # reference's ragged packed tensors; default on, TPU-validated
        ("packed-compaction", B, True, None, None),
        # image-axis gradient accumulation + the single-dispatch fused step
        # (TrainerConfig.micro_batch_imgs / fused_micro_step)
        ("micro-batch-imgs", int, 1, None, None),
        ("fused-micro-step", B, False, None, None),
        # pipelined loss readback depth (TrainerConfig.dispatch_ahead);
        # 0 = sync every step (NaN hunting)
        ("dispatch-ahead", int, 4, None, None),
        ("inst-num-dilations", int, -1, None, None),
        # minimum instance-mask pixel count kept by the validation cleanup; the
        # reference hardcodes 100 (tuned for 1280x720 berries,
        # pc_nerf/trainer.py:765) — at small synthetic resolutions whole valid
        # spheres are 45-220 px, so 100 deletes half of them (mAP halves on
        # PERFECT GT input). Scale with image area.
        ("inst-min-mask-px", int, 100, None, None),
        ("low-res-val", B, False, None, None),
        ("random-lod", B, False, None, None),
        ("growth-strategy", str, "increase", None, None),
        ("log-sub-losses", B, False, None, None),
        ("optimize-extrinsics", B, False, None, None),
        ("extrinsics-epoch-start", int, 0, None, None),
        ("extrinsics-epoch-end", int, -1, None, None),
        ("clustering-epoch-start", int, 0, None, None),
        ("num-clustering-samples", int, 0, None, None),
        ("num-clustering-workers", int, 1, None, None),
        ("lod-anneling", B, False, None, None),
        ("lod-annel-epochs", int, 0, None, None),
        ("lod-annel-epoch-start", int, 0, None, None),
        ("inst-epoch-start", int, 0, None, None),
        ("inst-loss", str, "sup_contrastive", None, None),
        ("inst-dist-func", str, "cos", ["l1", "l2", "cos"], None),
        ("inst-conf-enable", B, False, None, None),
        ("inst-normalize", B, False, None, None),
        ("weight-class-inbalance", B, False, None, None),
        ("inst-temperature", float, 0.07, None, None),
        ("inst-soft-temperature", float, 0.0, None, None),
        ("base-temperature", float, 0.07, None, None),
        ("inst-pn-ratio", float, 0.5, None, None),
        ("sem-segment-reg-weight", float, 0.0, None, None),
        ("inst-segment-reg-weight", float, 0.0, None, None),
        ("inst-segment-reg-epoch-start", float, -1, None, None),
        ("optimize-val-extrinsics", B, False, None, None),
        ("val-extrinsics-start", int, 0, None, None),
        ("val-extrinsics-every", int, 0, None, None),
        ("val-extrinsics-end", int, -1, None, None),
    ],
    "validation": [
        ("valid-only", B, False, None, None),
        ("valid-every", int, -1, None, None),
        ("valid-split", str, "val", None, None),
    ],
    # interactive-viewer equivalents (reference app/app.py runs an OpenGL window;
    # here --viewer serves the same channels + click-to-embedding-distance over
    # HTTP, and --render-views runs the offline orbit renderer)
    "app": [
        ("render-views", B, False, None, None),
        ("render-views-dir", str, "", None, None),
        ("viewer", B, False, None, None),
        ("viewer-port", int, 8080, None, None),
    ],
    "renderer": [
        ("render-res", int, [512, 512], None, 2),
        ("render-batch", int, 0, None, None),
        ("camera-origin", float, [-2.8, 2.8, -2.8], None, 3),
        ("camera-lookat", float, [0, 0, 0], None, 3),
        ("camera-fov", float, 30, None, None),
        ("camera-proj", str, "persp", ["ortho", "persp"], None),
        ("camera-clamp", float, [0, 10], None, 2),
        ("tracer-type", str, "PackedRFTracer", None, None),
        ("num-val-frames-to-save", int, 0, None, None),
        ("num-steps", int, 128, None, None),
        ("step-size", float, 1.0, None, None),
        ("ray-max-travel", float, 6.0, None, None),
        ("min-dis", float, 0.0003, None, None),
        ("matcap-path", str, "data/matcaps/matcap_plastic_yellow.jpg", None, None),
        ("ao", B, False, None, None),
        ("shadow", B, False, None, None),
        ("shading-mode", str, "normal", ["matcap", "rb", "normal"], None),
    ],
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="pagnerf_tpu_torch",
                                     fromfile_prefix_chars="@")
    parser.add_argument("--log_level", type=int, default=20)
    for group_name, flags in FLAG_GROUPS.items():
        group = parser.add_argument_group(group_name)
        for name, typ, default, choices, nargs in flags:
            kw: Dict[str, Any] = {"default": default}
            if typ is B:
                kw.update(type=_str2bool, nargs="?", const=True)
            else:
                kw["type"] = typ
            if choices:
                kw["choices"] = choices
            if nargs and typ is not B:
                kw["nargs"] = nargs
            group.add_argument(f"--{name}", **kw)
    return parser


def parse_yaml_config(config_path: str, parser: argparse.ArgumentParser):
    """YAML sets parser defaults; one level of ``parent`` inheritance; unknown fields
    are rejected (reference config_parser.py:557-603)."""
    with open(config_path) as f:
        config_dict = yaml_lite.load(f.read())

    list_of_valid_fields = []
    for group in parser._action_groups:
        group_dict = {a.dest: a for a in group._group_actions}
        list_of_valid_fields.extend(list(group_dict.keys()))
    list_of_valid_fields = set(list_of_valid_fields)

    defaults_dict: Dict[str, Any] = {}

    def parse_and_merge(d: Dict):
        for key in d:
            if key in ("global", "optional arguments", "positional arguments") or \
                    d[key] is None:
                fields = d[key] if isinstance(d.get(key), dict) else {}
            elif isinstance(d[key], dict):
                fields = d[key]
            else:
                fields = {key: d[key]}
            for field, value in (fields or {}).items():
                if field == "config":
                    continue
                if field not in list_of_valid_fields:
                    raise ValueError(
                        f"ERROR: {field} is not a valid option. Check for typos.")
                defaults_dict[field] = value

    if "parent" in config_dict:
        parent_path = config_dict.pop("parent")
        if not os.path.isabs(parent_path):
            # relative to the CHILD config's directory, not the CWD
            # (reference config_parser.py:579-580)
            parent_path = os.path.join(os.path.dirname(config_path), parent_path)
        with open(parent_path) as f:
            parent_dict = yaml_lite.load(f.read())
        if "parent" in parent_dict:
            raise Exception("Hierarchical configs of more than 1 level deep "
                            "are not allowed.")
        parse_and_merge(parent_dict)
    parse_and_merge(config_dict)
    parser.set_defaults(**defaults_dict)


def parse_options(args=None):
    """Parse CLI args with optional --config YAML defaults
    (reference parse_options + main flow, main_interactive.py:23-27)."""
    parser = build_parser()
    ns, _ = parser.parse_known_args(args)
    if ns.config is not None:
        parse_yaml_config(ns.config, parser)
    return parser.parse_args(args)


def argparse_to_str(parser: argparse.ArgumentParser, args) -> str:
    """Pretty config dump grouped like the YAML schema
    (reference argparse_to_str)."""
    args_dict = {}
    for group in parser._action_groups:
        group_dict = {a.dest: getattr(args, a.dest, None)
                      for a in group._group_actions}
        args_dict[group.title] = group_dict
    return pprint.pformat(args_dict)


def config_to_yaml(parser: argparse.ArgumentParser, args) -> str:
    """Config snapshot YAML (reference writes one per run,
    main_interactive.py:96-99)."""
    out = {}
    for group in parser._action_groups:
        if not group._group_actions:
            continue
        out[group.title] = {a.dest: getattr(args, a.dest, None)
                            for a in group._group_actions}
    return yaml_lite.dump(out)
