"""Render a folder-per-identity dataset of aligned synthetic faces.

Counterpart of ``scripts/render_id_folders.py``: ``<out>/id_{i:05d}/{k:03d}.png``
from ``training/synthetic_faces.render_aligned_identity_sample``, identity
``i`` drawn from ``np.random.default_rng(seed * 100003 + i)`` and its sample
``k`` from ``np.random.default_rng((seed, i, k))``, as JAX draws them, so
different seeds give disjoint identity pools. PNG through
``utils/imageio.save_png`` (JAX: ``cv2.imwrite``; PNG is lossless, so the
files hold the rendered pixels, truncated to uint8 as both do). Samples are
rendered in ``workers`` threads (8 from the command line) (the rasteriser drops the GIL); each has
its own generator, so the files do not depend on the thread count.

    python -m facerecognition_tpu_torch.scripts.render_id_folders --out ids --n-ids 500 --per-id 24
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def render_id_folders(out: str, n_ids: int = 500, per_id: int = 24, size: int = 160,
                      seed: int = 0, workers: int = 8, log=print) -> dict:
    """Render the folders; returns ``{"images", "seconds", "images_per_s"}``."""
    from facerecognition_tpu_torch.training.synthetic_faces import (
        render_aligned_identity_sample,
        sample_identity,
    )
    from facerecognition_tpu_torch.utils.imageio import save_png

    t0 = time.perf_counter()
    ids = [sample_identity(np.random.default_rng(seed * 100003 + i)) for i in range(n_ids)]
    for i in range(n_ids):
        os.makedirs(os.path.join(out, f"id_{i:05d}"), exist_ok=True)

    def render(job):
        i, k = job
        img = render_aligned_identity_sample(np.random.default_rng((seed, i, k)), ids[i], size)
        save_png(os.path.join(out, f"id_{i:05d}", f"{k:03d}.png"), img.astype(np.uint8))

    jobs = [(i, k) for i in range(n_ids) for k in range(per_id)]
    with ThreadPoolExecutor(max_workers=max(workers, 1)) as pool:
        for done, _ in enumerate(pool.map(render, jobs), 1):
            if log is not None and done % (50 * per_id) == 0:
                rate = done / max(time.perf_counter() - t0, 1e-9)
                log(f"{done // per_id}/{n_ids} ids ({rate:.0f} img/s, "
                    f"eta {(len(jobs) - done) / max(rate, 1e-9):.0f}s)")
    seconds = time.perf_counter() - t0
    return {"images": len(jobs), "seconds": seconds, "images_per_s": len(jobs) / max(seconds, 1e-9)}


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Render aligned synthetic identity folders")
    ap.add_argument("--out", required=True)
    ap.add_argument("--n-ids", type=int, default=500)
    ap.add_argument("--per-id", type=int, default=24)
    ap.add_argument("--size", type=int, default=160)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    out = render_id_folders(args.out, args.n_ids, args.per_id, args.size, args.seed)
    print(f"rendered {out['images']} images -> {args.out} ({out['seconds']:.0f}s)")
    return out


if __name__ == "__main__":
    main()
