"""Create a label map from a metadata CSV, or from a folder-per-identity
dataset when no CSV serves. Counterpart of
``facerecognition_tpu/scripts/create_label_map.py``.

Priority: a CSV with ``identity_id`` + ``label`` columns (the global id
mapping), then ``image_path`` + ``label`` (a split's labels: the identity
is each path's parent folder), then a directory scan
(``data.datasets.FolderDataset``). Writes ``label_map.npy`` ({int label:
str identity}). pandas is imported inside.

    python -m facerecognition_tpu_torch.scripts.create_label_map --csv m.csv --output lm.npy
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def create_label_map(
    metadata_csv: Optional[str] = None,
    dataset_dir: Optional[str] = None,
    output_path: str = "label_map.npy",
) -> dict[int, str]:
    label_map: dict[int, str] = {}
    if metadata_csv and os.path.exists(metadata_csv):
        import pandas as pd

        df = pd.read_csv(metadata_csv)
        if {"identity_id", "label"} <= set(df.columns):
            label_map = {int(r["label"]): str(r["identity_id"]) for _, r in df.iterrows()}
        elif {"image_path", "label"} <= set(df.columns):
            for _, r in df.iterrows():
                label_map.setdefault(
                    int(r["label"]), os.path.basename(os.path.dirname(str(r["image_path"])))
                )
    if not label_map and dataset_dir and os.path.isdir(dataset_dir):
        from facerecognition_tpu_torch.data.datasets import FolderDataset

        label_map = dict(enumerate(FolderDataset(dataset_dir).label_names))
    if not label_map:
        raise ValueError("no usable metadata CSV or dataset directory")
    d = os.path.dirname(output_path)
    if d:
        os.makedirs(d, exist_ok=True)
    np.save(output_path, label_map, allow_pickle=True)
    return label_map


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="Create label map")
    parser.add_argument("--csv", default=None)
    parser.add_argument("--dataset-dir", default=None)
    parser.add_argument("--output", default="label_map.npy")
    args = parser.parse_args(argv)
    m = create_label_map(args.csv, args.dataset_dir, args.output)
    print(f"{len(m)} labels → {args.output}")
    return m


if __name__ == "__main__":
    main()
