"""COCO-133 panoptic taxonomy + parent-class mapping.

Counterpart of `fusion3dseg_tpu/utils/taxonomy.py` (NumPy only, the same tables).

The reference depends on three external files that are NOT in its repo
(SURVEY.md vital stats): classes.csv (per-class parent taxonomy + removal
flags, read by get3DSeg.load_csv :357-367), classes_meta.json (parent names
+ color palette, get3DSeg.py:377-396) and coco_meta.json (the 133
stuff_classes names, get3DSeg.py:68). This module bakes in working defaults
for all three — the COCO panoptic class list OneFormer predicts over, an
indoor-scanning parent taxonomy (Walls/Ceilings/Floors/Doors/Windows/... per
the reference's ObjLegend, planeUtils.py:10-11) derived from class names —
while still reading user-provided csv/json files in the reference's formats.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

# COCO panoptic categories in OneFormer/detectron2 contiguous-id order:
# 80 "thing" classes then 53 "stuff" classes.
COCO_133_CLASSES: List[str] = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
    "banner", "blanket", "bridge", "cardboard", "counter", "curtain",
    "door-stuff", "floor-wood", "flower", "fruit", "gravel", "house", "light",
    "mirror-stuff", "net", "pillow", "platform", "playingfield", "railroad",
    "river", "road", "roof", "sand", "sea", "shelf", "snow", "stairs", "tent",
    "towel", "wall-brick", "wall-stone", "wall-tile", "wall-wood",
    "water-other", "window-blind", "window-other", "tree-merged",
    "fence-merged", "ceiling-merged", "sky-other-merged", "cabinet-merged",
    "table-merged", "floor-other-merged", "pavement-merged",
    "mountain-merged", "grass-merged", "dirt-merged", "paper-merged",
    "food-other-merged", "building-other-merged", "rock-merged",
    "wall-other-merged", "rug-merged",
]
assert len(COCO_133_CLASSES) == 133

# COCO panoptic contiguous-id layout: the first 80 categories are "thing"
# classes (instanceable), the remaining 53 "stuff" — the isthing split the
# reference's OneFormer info dicts carry (get2DSeg.py:74-78).
N_THING_CLASSES = 80

# parent classes (classes_meta.json 'classes' equivalent); index = parent_id
PARENT_CLASSES: List[str] = [
    "Walls", "Ceilings", "Floors", "Beams", "Columns", "Doors", "Windows",
    "Pipes", "Furniture", "Objects", "unclassified",
]
UNCLASSIFIED_PARENT = PARENT_CLASSES.index("unclassified")

# deterministic parent palette (classes_meta.json 'colors' equivalent), 0-255
PARENT_COLORS: np.ndarray = np.array(
    [
        [174, 199, 232],  # Walls
        [255, 187, 120],  # Ceilings
        [152, 223, 138],  # Floors
        [140, 86, 75],  # Beams
        [196, 156, 148],  # Columns
        [214, 39, 40],  # Doors
        [31, 119, 180],  # Windows
        [127, 127, 127],  # Pipes
        [188, 189, 34],  # Furniture
        [23, 190, 207],  # Objects
        [0, 0, 0],  # unclassified
    ],
    np.int64,
)


def _default_parent(name: str) -> str:
    n = name.lower()
    if n == "unclassified":
        return "unclassified"
    if "wall" in n:
        return "Walls"
    if "ceiling" in n or n == "roof":
        return "Ceilings"
    if "floor" in n or "rug" in n or "pavement" in n:
        return "Floors"
    if "door" in n:
        return "Doors"
    if "window" in n:
        return "Windows"
    if n in (
        "chair", "couch", "bed", "dining table", "bench", "shelf", "counter",
        "cabinet-merged", "table-merged", "toilet", "potted plant",
    ):
        return "Furniture"
    return "Objects"


_BUILDING_PARENTS = {"Walls", "Ceilings", "Floors", "Doors", "Windows", "Beams", "Columns", "Pipes"}


class Taxonomy:
    """Holds the class_id -> (parent_id, flags) table.

    Mirrors the reference load_csv return contract (get3DSeg.py:357-367):
    class_id list, parent names, parent ids, flag_infojson, building_classes
    (= class ids with flag_objremoval == False, i.e. kept by remove_classes).
    """

    def __init__(
        self,
        class_names: Optional[Sequence[str]] = None,
        parent_names: Optional[Sequence[str]] = None,
        parent_ids: Optional[Sequence[int]] = None,
        flag_infojson: Optional[Sequence[bool]] = None,
        flag_objremoval: Optional[Sequence[bool]] = None,
        parent_classes: Sequence[str] = PARENT_CLASSES,
        parent_colors: np.ndarray = PARENT_COLORS,
    ):
        if class_names is None:
            # include the trailing class 133 'unclassified' — the reference's
            # classes.csv carries it (get3DSeg.master_classes handles
            # category_id 133 inside the in-taxonomy branch, :430-431)
            class_names = COCO_133_CLASSES + ["unclassified"]
        self.class_names = list(class_names)
        self.parent_classes = list(parent_classes)
        self.parent_colors = np.asarray(parent_colors)
        n = len(self.class_names)
        self.class_ids = list(range(n))
        if parent_names is None:
            parent_names = [_default_parent(c) for c in self.class_names]
        self.parent_names = list(parent_names)
        if parent_ids is None:
            parent_ids = [self.parent_classes.index(p) for p in self.parent_names]
        self.parent_ids = [int(p) for p in parent_ids]
        if flag_infojson is None:
            flag_infojson = [True] * n
        self.flag_infojson = list(flag_infojson)
        if flag_objremoval is None:
            flag_objremoval = [p not in _BUILDING_PARENTS for p in self.parent_names]
        self.flag_objremoval = list(flag_objremoval)

    @property
    def building_classes(self) -> List[int]:
        return [cid for cid, rm in zip(self.class_ids, self.flag_objremoval) if not rm]

    def as_load_csv_tuple(self) -> Tuple[list, list, list, list, list]:
        """The exact 5-tuple of the reference's load_csv."""
        return (
            self.class_ids,
            self.parent_names,
            self.parent_ids,
            self.flag_infojson,
            self.building_classes,
        )

    @classmethod
    def from_csv(cls, path) -> "Taxonomy":
        """Read a classes.csv in the reference's column format:
        Class_ID, Parent, Parent_ID, flag_infojson, flag_objremoval."""
        import pandas as pd

        df = pd.read_csv(path)
        n = int(df["Class_ID"].max()) + 1
        # the reference's classes.csv carries 134 rows (COCO-133 +
        # 'unclassified'); falling through to numeric names for n == 134
        # would silently lose every real class name on a to_csv round-trip
        full = list(COCO_133_CLASSES) + ["unclassified"]
        names = full if n <= len(full) else [str(i) for i in range(n)]
        return cls(
            class_names=names[:n],
            parent_names=df["Parent"].tolist(),
            parent_ids=df["Parent_ID"].tolist(),
            flag_infojson=[bool(x) for x in df["flag_infojson"].tolist()],
            flag_objremoval=[bool(x) for x in df["flag_objremoval"].tolist()],
        )

    def to_csv(self, path) -> None:
        import pandas as pd

        pd.DataFrame(
            {
                "Class_ID": self.class_ids,
                "Parent": self.parent_names,
                "Parent_ID": self.parent_ids,
                "flag_infojson": self.flag_infojson,
                "flag_objremoval": self.flag_objremoval,
            }
        ).to_csv(path, index=False)

    def classes_meta(self) -> dict:
        """classes_meta.json equivalent (get3DSeg.py:388-396)."""
        return {
            "classes": self.parent_classes,
            "colors": self.parent_colors.tolist(),
        }


def stuff_classes_with_unclassified(
    coco_meta_path=None, nclasses: int = 133
) -> List[str]:
    """Class-name list + trailing 'unclassified' (get3DSeg.py:252-257)."""
    if coco_meta_path is not None and Path(coco_meta_path).is_file():
        import json

        with open(coco_meta_path) as fp:
            names = list(json.load(fp)["stuff_classes"])
    elif nclasses == 133:
        names = list(COCO_133_CLASSES)
    else:
        names = [str(i) for i in range(nclasses)]
    names.append("unclassified")
    return names
