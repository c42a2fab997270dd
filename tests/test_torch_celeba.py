"""The port's CelebA preprocessor and ``augment_batch`` against the JAX
package on the CPU.

A CelebA-like set is built around rendered one-face scenes (JPEG through
PIL, the landmark CSV missing one image). Each step of
``CelebAPreprocessor`` is held to JAX's on the same input:

- metadata, filtering and grouping equal;
- aligned crops within a level of JAX's (the closed-form Umeyama moves a
  sample by ~1e-5 px, 0.0085 levels before the truncation to uint8), the
  no-landmark resize likewise;
- the augmentation given JAX's draws (``augment_draws``' argument form,
  as ``tests/test_torch_augment.py``) within a level of JAX's batch;
- the split membership, file names and CSVs equal; the JPEG files
  (``encode_jpeg`` at quality 95, JAX: PIL) decode to the written arrays
  with a mean error within 1.25x of PIL's own round trip.

The contracts of ``tests/test_pipeline_tools.py:48-95`` are repeated on the
port. ``augment_batch(generator, ...)`` is held equal to the two-call form
on one generator.
"""

import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from facerecognition_tpu.preprocessing import celeba as jax_celeba
from facerecognition_tpu_torch.data.augment import apply_augment, augment_batch, augment_draws
from facerecognition_tpu_torch.data.native_decode import decode_file
from facerecognition_tpu_torch.preprocessing import celeba
from facerecognition_tpu_torch.preprocessing.celeba import (
    LANDMARK_COLUMNS,
    CelebAConfig,
    CelebAPreprocessor,
)
from facerecognition_tpu_torch.training.synthetic_faces import render_scene
from facerecognition_tpu_torch.utils.imageio import encode_jpeg
from test_torch_augment import jax_draws

JPEG_RATIO = 1.25  # the port's JPEG mean error against PIL's, same arrays


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: six workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def celeba_dir(tmp_path_factory):
    """Three persons of 6, 6 and 2 rendered scenes (the last filtered at
    5), 96² and 112² so a batch is padded; image 001002 has no landmarks."""
    root = tmp_path_factory.mktemp("celeba")
    img_dir = root / "img_align_celeba"
    img_dir.mkdir()
    rng = np.random.default_rng(5)
    idents, rows = [], []
    for pid in range(3):
        for i in range(6 if pid < 2 else 2):
            name = f"{pid:03d}{i:03d}.jpg"
            img, _, lms, _ = render_scene(rng, 96 + 16 * (i % 2), 1, 1.0)
            Image.fromarray(img.astype(np.uint8)).save(img_dir / name, quality=92)
            idents.append(f"{name} {pid + 1}")
            if name != "001002.jpg":
                rows.append([name] + lms[0].reshape(-1).round(1).tolist())
    (root / "identity_CelebA.txt").write_text("\n".join(idents) + "\n")
    pd.DataFrame(rows, columns=("image_id",) + LANDMARK_COLUMNS).to_csv(
        root / "list_landmarks_align_celeba.csv", index=False)
    return str(root)


def configs(celeba_dir, out, **kw):
    args = dict(data_dir=celeba_dir, output_dir=out, min_images=5, target_min_images=8, batch_size=4)
    args.update(kw)
    return CelebAConfig(**args), jax_celeba.CelebAConfig(**args)


def test_full_run_contract(celeba_dir, tmp_path):
    out = str(tmp_path / "out")
    stats = CelebAPreprocessor(configs(celeba_dir, out)[0], device="cpu").run()
    assert stats["n_identities"] == 3 and stats["n_identities_kept"] == 2
    assert sum(stats["split_counts"].values()) >= 16
    assert os.path.exists(os.path.join(out, "metadata", "global_id_mapping.csv"))
    train = pd.read_csv(os.path.join(out, "metadata", "train_labels.csv"))
    assert {"image_path", "identity_id", "label"} <= set(train.columns)
    assert decode_file(train.iloc[0]["image_path"]).shape == (112, 112, 3)


def test_by_identity_split_contract(celeba_dir, tmp_path):
    out = str(tmp_path / "out2")
    CelebAPreprocessor(configs(celeba_dir, out, target_min_images=5, split_mode="by_identity",
                               train_frac=0.5, val_frac=0.5)[0], device="cpu").run()
    train = pd.read_csv(os.path.join(out, "metadata", "train_labels.csv"))
    val = pd.read_csv(os.path.join(out, "metadata", "val_labels.csv"))
    assert not set(train["identity_id"]) & set(val["identity_id"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CelebAPreprocessor(configs(celeba_dir, out)[0])


@pytest.mark.parametrize("split_mode", ["by_image", "by_identity"])
def test_steps_match_jax(celeba_dir, tmp_path, monkeypatch, split_mode):
    ours_cfg, jax_cfg = configs(celeba_dir, str(tmp_path / "port"), split_mode=split_mode)
    jax_cfg.output_dir = str(tmp_path / "jax")
    ours, theirs = CelebAPreprocessor(ours_cfg, device="cpu"), jax_celeba.CelebAPreprocessor(jax_cfg)
    for pre in (ours, theirs):
        pre.load_metadata()
        pre.analyze_and_filter()
    assert ours.by_person == theirs.by_person and ours.stats == theirs.stats
    assert ours.identity == theirs.identity
    assert set(ours.landmarks) == set(theirs.landmarks)

    aligned, want = ours.align_all(), theirs.align_all()
    assert list(aligned) == list(want)
    for pid in want:
        assert len(aligned[pid]) == len(want[pid])
        for a, b in zip(aligned[pid], want[pid]):
            d = np.abs(a.astype(int) - b)
            assert d.max() <= 1 and (d > 0).mean() < 0.01

    # the augmentation on JAX's draws, from JAX's aligned crops
    key = [jax.random.PRNGKey(jax_cfg.seed)]

    def draws_of_jax(generator, images, tier):
        key[0], sub = jax.random.split(key[0])
        return apply_augment(images, jax_draws(sub, images.shape[0], images.shape[1], tier), tier)

    monkeypatch.setattr(celeba, "augment_batch", draws_of_jax)
    src = {p: [a.copy() for a in v] for p, v in want.items()}
    augmented = ours.augment_to_target({p: [a.copy() for a in v] for p, v in src.items()})
    want_aug = theirs.augment_to_target(src)
    for pid in want_aug:
        assert len(augmented[pid]) == len(want_aug[pid]) == jax_cfg.target_min_images
        for a, b in zip(augmented[pid], want_aug[pid]):
            assert np.abs(a.astype(int) - b).max() <= 1

    counts = ours.split_and_write({p: list(v) for p, v in want_aug.items()})
    assert counts == theirs.split_and_write({p: list(v) for p, v in want_aug.items()})
    assert ours.stats == theirs.stats
    for name in ("global_id_mapping.csv", "train_labels.csv", "val_labels.csv", "test_labels.csv"):
        texts = []
        for cfg in (ours_cfg, jax_cfg):
            with open(os.path.join(cfg.output_dir, "metadata", name)) as f:
                texts.append(f.read().replace(cfg.output_dir + os.sep, ""))
        assert texts[0] == texts[1], name
    for split, n in counts.items():
        for cfg in (ours_cfg, jax_cfg):
            files = sorted(os.path.relpath(os.path.join(d, f), cfg.output_dir)
                           for d, _, fs in os.walk(os.path.join(cfg.output_dir, split)) for f in fs)
            assert len(files) == n
            if cfg is ours_cfg:
                port_files = files
        assert port_files == files
    # the written JPEGs: the port's encoder against PIL's on the same arrays
    port_err, pil_err = [], []
    for img in [img for imgs in want_aug.values() for img in imgs][:8]:
        Image.fromarray(img).save(tmp_path / "pil.jpg", quality=95)
        with open(tmp_path / "port.jpg", "wb") as f:
            f.write(encode_jpeg(img, quality=celeba.JPEG_QUALITY))
        pil_err.append(np.abs(decode_file(tmp_path / "pil.jpg").astype(int) - img).mean())
        port_err.append(np.abs(decode_file(tmp_path / "port.jpg").astype(int) - img).mean())
    assert np.mean(port_err) <= JPEG_RATIO * np.mean(pil_err), (port_err, pil_err)


def test_augment_batch_one_call_equals_two_calls():
    images = torch.as_tensor(np.random.default_rng(2).integers(0, 256, (6, 40, 40, 3), dtype=np.uint8))
    for tier in ("none", "light", "normal", "heavy"):
        got = augment_batch(torch.Generator().manual_seed(9), images, tier)
        g = torch.Generator().manual_seed(9)
        want = apply_augment(images, augment_draws(g, 6, 40, tier), tier)
        assert torch.equal(got, want), tier
        assert got.shape == (6, 40, 40, 3) and got.dtype == torch.float32
