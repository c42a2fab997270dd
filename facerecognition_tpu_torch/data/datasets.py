"""Dataset indexes: folder scan, CSV (auto-detected formats), splits, guards.

A copy of ``facerecognition_tpu/data/datasets.py`` (host numpy; pandas is
imported by ``CSVDataset`` only). Host-side metadata only. Rebuilds:
- FolderBasedDataset with min-images filter + sorted digit-aware label map
  (reference arcface_dataloader.py:24-144, train_lbph_script.py:22-47)
- ArcFaceDataset CSV with 3 auto-detected column formats
  (arcface_dataloader.py:147-250)
- by_image / by_identity splits (celeba_preprocessing.py:321)
- the identity-overlap (data-leakage) validator that RAISES
  (facenet_dataloader.py:287-339)
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _digit_aware_key(name: str):
    """Sort 'person2' before 'person10' (reference train_lbph_script.py:22-47)."""
    return [
        int(tok) if tok.isdigit() else tok
        for tok in re.split(r"(\d+)", name)
    ]


@dataclass
class DatasetIndex:
    """Flat sample index: paths + integer labels + label names."""

    paths: list[str]
    labels: np.ndarray  # (N,) int64
    label_names: list[str]  # label id → human name

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def num_classes(self) -> int:
        return len(self.label_names)

    def subset(self, indices: Sequence[int]) -> "DatasetIndex":
        idx = np.asarray(indices)
        return DatasetIndex(
            [self.paths[i] for i in idx],
            self.labels[idx],
            self.label_names,
        )


class FolderDataset(DatasetIndex):
    """person-per-folder scan with min-images filter."""

    def __init__(self, root: str, min_images: int = 1):
        root = os.fspath(root)
        people = sorted(
            (
                d
                for d in os.listdir(root)
                if os.path.isdir(os.path.join(root, d))
            ),
            key=_digit_aware_key,
        )
        paths: list[str] = []
        labels: list[int] = []
        names: list[str] = []
        for person in people:
            pdir = os.path.join(root, person)
            files = sorted(
                f
                for f in os.listdir(pdir)
                if f.lower().endswith(IMAGE_EXTS)
            )
            if len(files) < min_images:
                continue
            label = len(names)
            names.append(person)
            for f in files:
                paths.append(os.path.join(pdir, f))
                labels.append(label)
        super().__init__(paths, np.asarray(labels, np.int64), names)


class CSVDataset(DatasetIndex):
    """CSV-driven dataset with auto-detected column formats.

    Accepted layouts (reference arcface_dataloader.py:147-250):
    1. columns (image_path | path | filename) + (label | identity | id)
    2. columns (image | file) + (person | name | class)
    3. two unnamed columns: first = path, second = label
    Paths resolve relative to ``image_root`` when given.
    """

    PATH_COLS = ("image_path", "path", "filename", "image", "file")
    LABEL_COLS = ("label", "identity", "id", "person", "name", "class")

    def __init__(self, csv_path: str, image_root: Optional[str] = None):
        import pandas as pd

        df = pd.read_csv(csv_path)
        path_col = next((c for c in self.PATH_COLS if c in df.columns), None)
        label_col = next((c for c in self.LABEL_COLS if c in df.columns), None)
        if path_col is None or label_col is None:
            if len(df.columns) >= 2:
                # Layout 3 (headerless): pandas promoted the first DATA row
                # to column names above — re-read without a header so that
                # sample isn't silently dropped.
                df = pd.read_csv(csv_path, header=None)
                path_col, label_col = df.columns[0], df.columns[1]
            else:
                raise ValueError(
                    f"cannot detect path/label columns in {list(df.columns)}"
                )
        raw_labels = df[label_col].astype(str).tolist()
        names = sorted(set(raw_labels), key=_digit_aware_key)
        name_to_id = {n: i for i, n in enumerate(names)}
        paths = [
            os.path.join(image_root, p) if image_root else str(p)
            for p in df[path_col].astype(str)
        ]
        labels = np.asarray([name_to_id[l] for l in raw_labels], np.int64)
        super().__init__(paths, labels, names)


def split_by_image(
    index: DatasetIndex, val_frac: float = 0.1, seed: int = 0
) -> tuple[DatasetIndex, DatasetIndex]:
    """Random per-image split — identities appear in both sides
    (classification-style eval; reference celeba_preprocessing.py:321)."""
    rng = np.random.default_rng(seed)
    n = len(index)
    perm = rng.permutation(n)
    n_val = int(round(n * val_frac))
    return index.subset(perm[n_val:]), index.subset(perm[:n_val])


def split_by_identity(
    index: DatasetIndex, val_frac: float = 0.1, seed: int = 0
) -> tuple[DatasetIndex, DatasetIndex]:
    """Disjoint-identity split (verification-style eval — the FaceNet
    contract, facenet_config.yaml by_id split)."""
    rng = np.random.default_rng(seed)
    classes = np.unique(index.labels)
    perm = rng.permutation(len(classes))
    n_val = int(round(len(classes) * val_frac))
    val_classes = set(classes[perm[:n_val]].tolist())
    val_idx = [i for i, l in enumerate(index.labels) if int(l) in val_classes]
    train_idx = [
        i for i, l in enumerate(index.labels) if int(l) not in val_classes
    ]
    return index.subset(train_idx), index.subset(val_idx)


def check_identity_overlap(
    train: DatasetIndex, val: DatasetIndex, raise_on_overlap: bool = True
) -> set:
    """Train/val identity-leakage guard — raises like the reference
    (facenet_dataloader.py:287-339)."""
    t = {train.label_names[int(l)] for l in np.unique(train.labels)}
    v = {val.label_names[int(l)] for l in np.unique(val.labels)}
    overlap = t & v
    if overlap and raise_on_overlap:
        raise ValueError(
            f"identity leakage: {len(overlap)} identities in both train and "
            f"val (e.g. {sorted(overlap)[:5]})"
        )
    return overlap
