"""Class taxonomies (a copy of ``pagnerf_tpu/data/formats/categories.py``):
stuff/things partitions and cross-dataset id mapping.

The agricultural taxonomies the loaders use (BUP20, SB20), the Replica
indoor taxonomy (stuff/things name partition and the 102-entry id -> name
table), the 150-category ADE20K panoptic taxonomy (name / isthing / color)
and the ADE20K -> Replica id map. The reference's ADE20K -> Replica dict
literal repeats keys (ade id 10 appears with values 2, 10, 18 and 94);
Python keeps the last entry, so the map below resolves duplicates last-wins
as the reference behaves.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

# --------------------------------------------------------------------------- BUP20
BUP20_CLASS_NAMES = ["bg", "pepper"]
BUP20_STUFF = ["bg"]
BUP20_THINGS = ["pepper"]

# ---------------------------------------------------------------------------- SB20
SB20_CLASS_NAMES = ["bg", "sugar_beet", "weed"]
SB20_STUFF = ["bg"]
SB20_THINGS = ["sugar_beet", "weed"]

# -------------------------------------------------------------------------- Replica
# Stuff = architectural/background surfaces; things = countable objects — the
# partition the panoptic metrics consume (reference categories.py:6-116).
REPLICA_STUFF_NAMES = [
    "no_class", "base-cabinet", "bathtub", "beam", "blinds", "cabinet", "curtain",
    "ceiling", "desk", "door", "faucet", "floor", "mat", "nightstand", "panel",
    "paper-towel", "pillar", "pipe", "plant-stand", "plate", "rack", "refrigerator",
    "shelf", "shower-stall", "sink", "stair", "table", "table-runner", "tv-stand",
    "utensil-holder", "vent", "wall", "wall-cabinet", "wall-plug", "wardrobe",
    "window", "rug", "logo", "set-of-clothing", "text", "anonymized-text", "plane",
    "non-plane", "lamp",
]
REPLICA_THINGS_NAMES = [
    "backpack", "basket", "beanbag", "bed", "bench", "bike", "bin", "blanket",
    "book", "bottle", "box", "bowl", "camera", "candle", "chair", "chopping-board",
    "clock", "cloth", "clothing", "coaster", "comforter", "computer-keyboard",
    "cup", "cushion", "cooktop", "countertop", "desk-organizer",
    "desktop-computer", "exercise-ball", "handbag", "hair-dryer", "handrail",
    "indoor-plant", "knife-block", "kitchen-utensil", "laptop", "major-appliance",
    "microwave", "monitor", "mouse", "pan", "phone", "picture", "pillow", "pot",
    "remote-control", "scarf", "sculpture", "shoe", "small-appliance", "sofa",
    "stool", "switch", "tablet", "tissue-paper", "toilet", "toothbrush", "towel",
    "tv-screen", "umbrella", "vase", "bag",
]

# Replica semantic id -> class name, ids 0..101 (reference categories.py:315-419).
# Note id 38 keeps the reference's "excercise-ball" spelling; the things list above
# spells it "exercise-ball" (also inconsistent in the reference) — the alias table
# below bridges the two.
REPLICA_ID_TO_NAME: Dict[int, str] = dict(enumerate([
    "no_class", "backpack", "base-cabinet", "basket", "bathtub", "beam",
    "beanbag", "bed", "bench", "bike", "bin", "blanket", "blinds", "book",
    "bottle", "box", "bowl", "camera", "cabinet", "candle", "chair",
    "chopping-board", "clock", "cloth", "clothing", "coaster", "comforter",
    "computer-keyboard", "cup", "cushion", "curtain", "ceiling", "cooktop",
    "countertop", "desk", "desk-organizer", "desktop-computer", "door",
    "excercise-ball", "faucet", "floor", "handbag", "hair-dryer", "handrail",
    "indoor-plant", "knife-block", "kitchen-utensil", "lamp", "laptop",
    "major-appliance", "mat", "microwave", "monitor", "mouse", "nightstand",
    "pan", "panel", "paper-towel", "phone", "picture", "pillar", "pillow",
    "pipe", "plant-stand", "plate", "pot", "rack", "refrigerator",
    "remote-control", "scarf", "sculpture", "shelf", "shoe", "shower-stall",
    "sink", "small-appliance", "sofa", "stair", "stool", "switch", "table",
    "table-runner", "tablet", "tissue-paper", "toilet", "toothbrush", "towel",
    "tv-screen", "tv-stand", "umbrella", "utensil-holder", "vase", "vent",
    "wall", "wall-cabinet", "wall-plug", "wardrobe", "window", "rug", "logo",
    "bag", "set-of-clothing",
]))
REPLICA_NAME_TO_ID = {n: i for i, n in REPLICA_ID_TO_NAME.items()}
_REPLICA_SPELLING_ALIASES = {"exercise-ball": "excercise-ball"}
REPLICA_STUFF_IDS = sorted(
    REPLICA_NAME_TO_ID[_REPLICA_SPELLING_ALIASES.get(n, n)]
    for n in REPLICA_STUFF_NAMES if _REPLICA_SPELLING_ALIASES.get(n, n)
    in REPLICA_NAME_TO_ID)
REPLICA_THINGS_IDS = sorted(
    REPLICA_NAME_TO_ID[_REPLICA_SPELLING_ALIASES.get(n, n)]
    for n in REPLICA_THINGS_NAMES if _REPLICA_SPELLING_ALIASES.get(n, n)
    in REPLICA_NAME_TO_ID)
REPLICA_CLASS_NAMES = [REPLICA_ID_TO_NAME[i] for i in range(len(REPLICA_ID_TO_NAME))]

# -------------------------------------------------------------------------- ADE20K
# The standard 150-category ADE20K panoptic taxonomy: (name, isthing, color),
# index = category id (reference categories.py:118-313; the public detectron2
# ADE20K_150_CATEGORIES table).
ADE20K_CATEGORIES: List[tuple] = [
    ("wall", 0, (120, 120, 120)), ("building", 0, (180, 120, 120)),
    ("sky", 0, (6, 230, 230)), ("floor", 0, (80, 50, 50)),
    ("tree", 0, (4, 200, 3)), ("ceiling", 0, (120, 120, 80)),
    ("road, route", 0, (140, 140, 140)), ("bed", 1, (204, 5, 255)),
    ("window ", 1, (230, 230, 230)), ("grass", 0, (4, 250, 7)),
    ("cabinet", 1, (224, 5, 255)), ("sidewalk, pavement", 0, (235, 255, 7)),
    ("person", 1, (150, 5, 61)), ("earth, ground", 0, (120, 120, 70)),
    ("door", 1, (8, 255, 51)), ("table", 1, (255, 6, 82)),
    ("mountain, mount", 0, (143, 255, 140)), ("plant", 0, (204, 255, 4)),
    ("curtain", 1, (255, 51, 7)), ("chair", 1, (204, 70, 3)),
    ("car", 1, (0, 102, 200)), ("water", 0, (61, 230, 250)),
    ("painting, picture", 1, (255, 6, 51)), ("sofa", 1, (11, 102, 255)),
    ("shelf", 1, (255, 7, 71)), ("house", 0, (255, 9, 224)),
    ("sea", 0, (9, 7, 230)), ("mirror", 1, (220, 220, 220)),
    ("rug", 0, (255, 9, 92)), ("field", 0, (112, 9, 255)),
    ("armchair", 1, (8, 255, 214)), ("seat", 1, (7, 255, 224)),
    ("fence", 1, (255, 184, 6)), ("desk", 1, (10, 255, 71)),
    ("rock, stone", 0, (255, 41, 10)), ("wardrobe, closet, press", 1, (7, 255, 255)),
    ("lamp", 1, (224, 255, 8)), ("tub", 1, (102, 8, 255)),
    ("rail", 1, (255, 61, 6)), ("cushion", 1, (255, 194, 7)),
    ("base, pedestal, stand", 0, (255, 122, 8)), ("box", 1, (0, 255, 20)),
    ("column, pillar", 1, (255, 8, 41)), ("signboard, sign", 1, (255, 5, 153)),
    ("chest of drawers, chest, bureau, dresser", 1, (6, 51, 255)),
    ("counter", 1, (235, 12, 255)), ("sand", 0, (160, 150, 20)),
    ("sink", 1, (0, 163, 255)), ("skyscraper", 0, (140, 140, 140)),
    ("fireplace", 1, (250, 10, 15)), ("refrigerator, icebox", 1, (20, 255, 0)),
    ("grandstand, covered stand", 0, (31, 255, 0)), ("path", 0, (255, 31, 0)),
    ("stairs", 1, (255, 224, 0)), ("runway", 0, (153, 255, 0)),
    ("case, display case, showcase, vitrine", 1, (0, 0, 255)),
    ("pool table, billiard table, snooker table", 1, (255, 71, 0)),
    ("pillow", 1, (0, 235, 255)), ("screen door, screen", 1, (0, 173, 255)),
    ("stairway, staircase", 0, (31, 0, 255)), ("river", 0, (11, 200, 200)),
    ("bridge, span", 0, (255, 82, 0)), ("bookcase", 1, (0, 255, 245)),
    ("blind, screen", 0, (0, 61, 255)), ("coffee table", 1, (0, 255, 112)),
    ("toilet, can, commode, crapper, pot, potty, stool, throne", 1, (0, 255, 133)),
    ("flower", 1, (255, 0, 0)), ("book", 1, (255, 163, 0)),
    ("hill", 0, (255, 102, 0)), ("bench", 1, (194, 255, 0)),
    ("countertop", 1, (0, 143, 255)), ("stove", 1, (51, 255, 0)),
    ("palm, palm tree", 1, (0, 82, 255)), ("kitchen island", 1, (0, 255, 41)),
    ("computer", 1, (0, 255, 173)), ("swivel chair", 1, (10, 0, 255)),
    ("boat", 1, (173, 255, 0)), ("bar", 0, (0, 255, 153)),
    ("arcade machine", 1, (255, 92, 0)),
    ("hovel, hut, hutch, shack, shanty", 0, (255, 0, 255)),
    ("bus", 1, (255, 0, 245)), ("towel", 1, (255, 0, 102)),
    ("light", 1, (255, 173, 0)), ("truck", 1, (255, 0, 20)),
    ("tower", 0, (255, 184, 184)), ("chandelier", 1, (0, 31, 255)),
    ("awning, sunshade, sunblind", 1, (0, 255, 61)),
    ("street lamp", 1, (0, 71, 255)), ("booth", 1, (255, 0, 204)),
    ("tv", 1, (0, 255, 194)), ("plane", 1, (0, 255, 82)),
    ("dirt track", 0, (0, 10, 255)), ("clothes", 1, (0, 112, 255)),
    ("pole", 1, (51, 0, 255)), ("land, ground, soil", 0, (0, 194, 255)),
    ("bannister, banister, balustrade, balusters, handrail", 1, (0, 122, 255)),
    ("escalator, moving staircase, moving stairway", 0, (0, 255, 163)),
    ("ottoman, pouf, pouffe, puff, hassock", 1, (255, 153, 0)),
    ("bottle", 1, (0, 255, 10)), ("buffet, counter, sideboard", 0, (255, 112, 0)),
    ("poster, posting, placard, notice, bill, card", 0, (143, 255, 0)),
    ("stage", 0, (82, 0, 255)), ("van", 1, (163, 255, 0)),
    ("ship", 1, (255, 235, 0)), ("fountain", 1, (8, 184, 170)),
    ("conveyer belt, conveyor belt, conveyer, conveyor, transporter", 0,
     (133, 0, 255)),
    ("canopy", 0, (0, 255, 92)),
    ("washer, automatic washer, washing machine", 1, (184, 0, 255)),
    ("plaything, toy", 1, (255, 0, 31)), ("pool", 0, (0, 184, 255)),
    ("stool", 1, (0, 214, 255)), ("barrel, cask", 1, (255, 0, 112)),
    ("basket, handbasket", 1, (92, 255, 0)), ("falls", 0, (0, 224, 255)),
    ("tent", 0, (112, 224, 255)), ("bag", 1, (70, 184, 160)),
    ("minibike, motorbike", 1, (163, 0, 255)), ("cradle", 0, (153, 0, 255)),
    ("oven", 1, (71, 255, 0)), ("ball", 1, (255, 0, 163)),
    ("food, solid food", 1, (255, 204, 0)), ("step, stair", 1, (255, 0, 143)),
    ("tank, storage tank", 0, (0, 255, 235)), ("trade name", 1, (133, 255, 0)),
    ("microwave", 1, (255, 0, 235)), ("pot", 1, (245, 0, 255)),
    ("animal", 1, (255, 0, 122)), ("bicycle", 1, (255, 245, 0)),
    ("lake", 0, (10, 190, 212)), ("dishwasher", 1, (214, 255, 0)),
    ("screen", 1, (0, 204, 255)), ("blanket, cover", 0, (20, 0, 255)),
    ("sculpture", 1, (255, 255, 0)), ("hood, exhaust hood", 1, (0, 153, 255)),
    ("sconce", 1, (0, 41, 255)), ("vase", 1, (0, 255, 204)),
    ("traffic light", 1, (41, 0, 255)), ("tray", 1, (41, 255, 0)),
    ("trash can", 1, (173, 0, 255)), ("fan", 1, (0, 245, 255)),
    ("pier", 0, (71, 0, 255)), ("crt screen", 0, (122, 0, 255)),
    ("plate", 1, (0, 255, 184)), ("monitor", 1, (0, 92, 255)),
    ("bulletin board", 1, (184, 255, 0)), ("shower", 0, (0, 133, 255)),
    ("radiator", 1, (255, 214, 0)),
    ("glass, drinking glass", 1, (25, 194, 194)), ("clock", 1, (102, 255, 0)),
    ("flag", 1, (92, 0, 255)),
]
ADE20K_CLASS_NAMES = [c[0] for c in ADE20K_CATEGORIES]
ADE20K_THINGS_IDS = [i for i, c in enumerate(ADE20K_CATEGORIES) if c[1]]
ADE20K_STUFF_IDS = [i for i, c in enumerate(ADE20K_CATEGORIES) if not c[1]]
ADE20K_COLORS = np.asarray([c[2] for c in ADE20K_CATEGORIES], np.uint8)

# ADE20K category id -> Replica class name. The reference encodes this as an id->id
# dict literal with duplicate keys (categories.py:421-496); Python keeps the last
# duplicate, and the effective (last-wins) mapping is reproduced here by name.
_ADE20K_TO_REPLICA_NAME = {
    0: "wall", 3: "floor", 5: "ceiling", 7: "bed", 8: "window",
    10: "wall-cabinet",          # cabinet: 2/10/18/94 in the source, last wins
    14: "door", 15: "table", 17: "plant-stand", 18: "curtain", 19: "chair",
    22: "picture", 23: "sofa", 24: "shelf", 28: "rug", 30: "chair",
    33: "desk", 35: "wardrobe", 36: "lamp", 37: "bathtub", 39: "cushion",
    41: "box", 42: "pillar", 47: "sink", 50: "refrigerator", 53: "stair",
    56: "table", 57: "pillow", 58: "door", 59: "stair", 61: "pan",
    62: "book", 63: "blinds", 64: "table", 65: "toilet", 67: "book",
    69: "bench", 70: "countertop", 74: "laptop", 75: "chair", 81: "towel",
    86: "blinds", 87: "lamp", 89: "tv-stand", 91: "rack", 95: "handrail",
    96: "stair", 97: "stool", 98: "bottle", 107: "mat", 112: "basket",
    115: "bag", 116: "bike", 119: "excercise-ball", 121: "stair",
    124: "microwave", 125: "pot", 131: "blanket", 132: "sculpture",
    135: "vase", 142: "plate", 143: "monitor", 145: "shower-stall",
    147: "cup", 148: "clock",
}
# ADE20K id -> Replica id as a dense 150-length lookup table; unmapped -> 0.
ADE20K_TO_REPLICA_IDS = np.zeros(len(ADE20K_CATEGORIES), np.int32)
for _ade_id, _rep_name in _ADE20K_TO_REPLICA_NAME.items():
    ADE20K_TO_REPLICA_IDS[_ade_id] = REPLICA_NAME_TO_ID[_rep_name]


def ade20k_to_replica(sem: np.ndarray) -> np.ndarray:
    """Vectorised ADE20K->Replica semantic-map remap (negative/out-of-range ids,
    e.g. -1 'unlabeled', map to Replica 0 'no_class')."""
    sem = np.asarray(sem)
    valid = (sem >= 0) & (sem < len(ADE20K_TO_REPLICA_IDS))
    return np.where(valid, ADE20K_TO_REPLICA_IDS[np.clip(sem, 0, None)
                                                 * valid], 0).astype(np.int32)


def class_partition(class_names: Sequence[str], stuff_names: Sequence[str]) -> Dict:
    """Build the semantic_info partition dict from name lists (the structure every
    format's ``get_semantic_info`` returns, e.g. bup20.py get_semantic_info)."""
    stuff = set(stuff_names)
    ids = list(range(len(class_names)))
    return {
        "class_id_to_name": dict(enumerate(class_names)),
        "num_classes": len(class_names),
        "classes_present": ids,
        "num_present_classes": len(ids),
        "stuff_ids": [i for i, n in enumerate(class_names) if n in stuff],
        "things_ids": [i for i, n in enumerate(class_names) if n not in stuff],
    }


def name_id_map(src_names: Sequence[str], dst_names: Sequence[str],
                aliases: Dict[str, str] | None = None,
                default: int = 0) -> List[int]:
    """Cross-taxonomy id map by name matching: src class id -> dst class id;
    unmatched classes map to ``default`` (background)."""
    aliases = aliases or {}
    dst_index = {n: i for i, n in enumerate(dst_names)}
    out = []
    for name in src_names:
        name = aliases.get(name, name)
        out.append(dst_index.get(name, default))
    return out
