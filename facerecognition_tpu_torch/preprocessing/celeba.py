"""CelebA dataset pipeline: align before augment, balance, split, metadata.

Counterpart of ``facerecognition_tpu/preprocessing/celeba.py``:

1. metadata: the identity list (space-separated), the landmark CSV
   (pandas, imported inside);
2. identities with fewer than ``min_images`` images dropped (at most
   ``max_identities`` kept, lowest ids first);
3. images grouped by identity, sorted by name;
4. alignment before augmentation: each image's five ground-truth landmarks
   → Umeyama → the 112² ArcFace template, in batches through
   ``ops/warp_sample.align_crop`` (one launch of the ``warp_sample`` kernel a
   batch on the card); an image without landmarks is resized
   (``ops/image.bilinear_resize``). Images are read by the port's decoder
   (``data/native_decode``; JAX reads them with PIL);
5. offline augmentation up to ``target_min_images`` an identity:
   ``data/augment.augment_batch`` (``warp_sample``'s matrix mode) on a
   ``torch.Generator`` on the host seeded with ``seed`` (JAX draws from
   ``jax.random``; the sources are picked by numpy as in JAX);
6. the train/val/test split, ``by_image`` or ``by_identity``, from
   ``np.random.default_rng(seed)`` as in JAX: the same membership;
7. a folder per identity and split, ``{k:04d}.jpg`` written by
   ``utils/imageio.encode_jpeg(quality=95)`` (JAX: PIL at quality 95), the
   per-split CSVs and the global label map.

    python -m facerecognition_tpu_torch.preprocessing.celeba <data_dir> <output_dir>
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from facerecognition_tpu_torch.data.augment import augment_batch
from facerecognition_tpu_torch.device import DeviceLike, resolve_device

LANDMARK_COLUMNS = (
    "lefteye_x", "lefteye_y", "righteye_x", "righteye_y", "nose_x",
    "nose_y", "leftmouth_x", "leftmouth_y", "rightmouth_x", "rightmouth_y",
)
JPEG_QUALITY = 95


@dataclass
class CelebAConfig:
    data_dir: str  # contains img_align_celeba/ + identity/landmark files
    output_dir: str
    identity_file: str = "identity_CelebA.txt"
    landmarks_file: str = "list_landmarks_align_celeba.csv"
    attributes_file: str = "list_attr_celeba.csv"
    bbox_file: str = "list_bbox_celeba.csv"
    images_subdir: str = "img_align_celeba"
    min_images: int = 5
    target_min_images: int = 10
    max_identities: Optional[int] = None
    image_size: int = 112
    split_mode: str = "by_image"  # by_image | by_identity
    train_frac: float = 0.8
    val_frac: float = 0.1
    seed: int = 0
    batch_size: int = 128  # alignment batch
    augment_tier: str = "normal"


class CelebAPreprocessor:
    def __init__(self, config: CelebAConfig, device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)
        self.identity: dict[str, int] = {}  # image name → person id
        self.landmarks: dict[str, np.ndarray] = {}  # image name → (5, 2)
        self.by_person: dict[int, list[str]] = {}
        self.stats: dict = {}

    # -- step 1: metadata ---------------------------------------------------

    def load_metadata(self) -> None:
        import pandas as pd

        c = self.config
        ident_path = os.path.join(c.data_dir, c.identity_file)
        if not os.path.exists(ident_path):
            raise FileNotFoundError(ident_path)
        df = pd.read_csv(ident_path, sep=r"\s+", header=None, names=["image", "identity_id"])
        self.identity = dict(zip(df["image"], df["identity_id"]))

        lm_path = os.path.join(c.data_dir, c.landmarks_file)
        if os.path.exists(lm_path):
            lm = pd.read_csv(lm_path)
            key = "image_id" if "image_id" in lm.columns else lm.columns[0]
            arr = lm[list(LANDMARK_COLUMNS)].to_numpy(np.float32).reshape(-1, 5, 2)
            self.landmarks = dict(zip(lm[key], arr))
        self.stats["n_images"] = len(self.identity)
        self.stats["n_identities"] = len(set(self.identity.values()))

    # -- steps 2-3: filter + group -------------------------------------------

    def analyze_and_filter(self) -> None:
        c = self.config
        counts: dict[int, int] = {}
        for pid in self.identity.values():
            counts[pid] = counts.get(pid, 0) + 1
        keep = {pid for pid, n in counts.items() if n >= c.min_images}
        if c.max_identities:
            keep = set(sorted(keep)[: c.max_identities])
        self.by_person = {}
        for img, pid in self.identity.items():
            if pid in keep:
                self.by_person.setdefault(pid, []).append(img)
        for imgs in self.by_person.values():
            imgs.sort()
        self.stats["n_identities_kept"] = len(self.by_person)
        self.stats["n_images_kept"] = sum(len(v) for v in self.by_person.values())

    # -- step 4: batched alignment on the device ------------------------------

    def align_all(self) -> dict[int, list[np.ndarray]]:
        """Align every kept image to the template in batches of
        ``batch_size`` (frames zero-padded to the batch's largest)."""
        from facerecognition_tpu_torch.data.native_decode import decode_file
        from facerecognition_tpu_torch.ops import warp_sample
        from facerecognition_tpu_torch.ops.image import bilinear_resize

        c = self.config
        img_root = os.path.join(c.data_dir, c.images_subdir)
        aligned: dict[int, list[np.ndarray]] = {p: [] for p in self.by_person}
        tasks = [(pid, name) for pid, names in self.by_person.items() for name in names]
        for start in range(0, len(tasks), c.batch_size):
            images, lms, owners = [], [], []
            for pid, name in tasks[start : start + c.batch_size]:
                try:
                    arr = decode_file(os.path.join(img_root, name))
                except OSError:  # missing or undecodable, as JAX skips it
                    continue
                lm = self.landmarks.get(name)
                if lm is None:  # no landmarks → plain resize
                    x = torch.as_tensor(arr, device=self.device)
                    out = bilinear_resize(x, c.image_size, c.image_size).clamp(0, 255)
                    aligned[pid].append(out.to(torch.uint8).cpu().numpy())
                    continue
                images.append(arr)
                lms.append(lm)
                owners.append(pid)
            if not images:
                continue
            h = max(im.shape[0] for im in images)
            w = max(im.shape[1] for im in images)
            padded = np.zeros((len(images), h, w, 3), np.uint8)
            for i, im in enumerate(images):
                padded[i, : im.shape[0], : im.shape[1]] = im
            out = warp_sample.align_crop(
                torch.as_tensor(padded, device=self.device),
                torch.as_tensor(np.stack(lms)[:, None], device=self.device),
                c.image_size,
            )
            out = out.clamp(0, 255).to(torch.uint8).cpu().numpy()
            for pid, crop in zip(owners, out):
                aligned[pid].append(crop)
        return aligned

    # -- step 5: offline augmentation ----------------------------------------

    def augment_to_target(self, aligned: dict[int, list[np.ndarray]]) -> dict[int, list[np.ndarray]]:
        c = self.config
        rng = np.random.default_rng(c.seed)
        generator = torch.Generator().manual_seed(c.seed)
        for pid, imgs in aligned.items():
            needed = c.target_min_images - len(imgs)
            if needed <= 0 or not imgs:
                continue
            src = np.stack([imgs[rng.integers(0, len(imgs))] for _ in range(needed)])
            out = augment_batch(generator, torch.as_tensor(src, device=self.device), c.augment_tier)
            imgs.extend(out.clamp(0, 255).to(torch.uint8).cpu().numpy())
        return aligned

    # -- steps 6-7: split + write ---------------------------------------------

    def split_and_write(self, aligned: dict[int, list[np.ndarray]]) -> dict:
        import pandas as pd

        from facerecognition_tpu_torch.utils.imageio import encode_jpeg

        c = self.config
        rng = np.random.default_rng(c.seed)
        splits: dict[str, list[tuple[int, np.ndarray]]] = {"train": [], "val": [], "test": []}

        def split_of(rank: int, n_train: int, n_val: int) -> str:
            return "train" if rank < n_train else "val" if rank < n_train + n_val else "test"

        if c.split_mode == "by_image":
            for pid, imgs in aligned.items():
                perm = rng.permutation(len(imgs))
                n_train = max(int(round(len(imgs) * c.train_frac)), 1)
                n_val = int(round(len(imgs) * c.val_frac))
                for rank, i in enumerate(perm):
                    splits[split_of(rank, n_train, n_val)].append((pid, imgs[i]))
        elif c.split_mode == "by_identity":
            pids = rng.permutation(sorted(aligned))
            n_train = int(round(len(pids) * c.train_frac))
            n_val = int(round(len(pids) * c.val_frac))
            for rank, pid in enumerate(pids):
                splits[split_of(rank, n_train, n_val)].extend((pid, im) for im in aligned[pid])
        else:
            raise ValueError(f"unknown split_mode {c.split_mode}")

        global_map = {pid: i for i, pid in enumerate(sorted(aligned))}
        meta_dir = os.path.join(c.output_dir, "metadata")
        os.makedirs(meta_dir, exist_ok=True)
        pd.DataFrame(
            [{"identity_id": p, "label": l} for p, l in global_map.items()]
        ).to_csv(os.path.join(meta_dir, "global_id_mapping.csv"), index=False)

        counters: dict[tuple[str, int], int] = {}
        records: dict[str, list[dict]] = {s: [] for s in splits}
        for split, items in splits.items():
            for pid, img in items:
                pdir = os.path.join(c.output_dir, split, str(pid))
                os.makedirs(pdir, exist_ok=True)
                k = counters.get((split, pid), 0)
                counters[(split, pid)] = k + 1
                path = os.path.join(pdir, f"{k:04d}.jpg")
                with open(path, "wb") as f:
                    f.write(encode_jpeg(img, quality=JPEG_QUALITY))
                records[split].append({"image_path": path, "identity_id": pid, "label": global_map[pid]})
        for split, rows in records.items():
            pd.DataFrame(rows).to_csv(os.path.join(meta_dir, f"{split}_labels.csv"), index=False)
        counts = {s: len(r) for s, r in records.items()}
        self.stats["split_counts"] = counts
        return counts

    def run(self) -> dict:
        """The whole pipeline; returns the stats dict."""
        self.load_metadata()
        self.analyze_and_filter()
        aligned = self.align_all()
        aligned = self.augment_to_target(aligned)
        self.split_and_write(aligned)
        return self.stats


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="CelebA preprocessing")
    parser.add_argument("data_dir")
    parser.add_argument("output_dir")
    parser.add_argument("--min-images", type=int, default=5)
    parser.add_argument("--target-min-images", type=int, default=10)
    parser.add_argument("--max-identities", type=int, default=None)
    parser.add_argument("--split-mode", choices=["by_image", "by_identity"], default="by_image")
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    config = CelebAConfig(
        data_dir=args.data_dir,
        output_dir=args.output_dir,
        min_images=args.min_images,
        target_min_images=args.target_min_images,
        max_identities=args.max_identities,
        split_mode=args.split_mode,
    )
    stats = CelebAPreprocessor(config, device=args.device).run()
    print(stats)
    return stats


if __name__ == "__main__":
    main()
