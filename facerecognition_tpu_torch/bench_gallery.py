"""Large-gallery match benchmark: exact top-k at the 1M-row regime.

Counterpart of the repository's ``bench_gallery.py``, with its flags,
defaults and JSON keys, plus ``--device``. The JAX script's paths map to
the port's, and their metric names with them:

- ``pallas_stream`` (``pallas_cosine_topk``) → ``ops.stream_topk.stream_topk``
  (the ``stream_topk`` kernel): ``gallery_match_qps_stream_topk_N{N}``;
- ``int8_mxu`` (``cosine_topk_int8`` from float queries) →
  ``ops.int8_topk.int8_topk`` from float queries (``int8_quantize``,
  ``int8_partial``, ``topk_merge``): ``gallery_match_qps_int8_topk_N{N}``;
- ``dense_xla`` (``cosine_topk``) → ``ops.matcher.cosine_topk``
  (``torch.matmul`` under ``strict_fp32``, then the top-k):
  ``gallery_match_qps_dense_torch_N{N}``;
- ``pallas_vs_dense_top1_agreement`` → ``stream_vs_dense_top1_agreement``
  (the stream kernel against dense); ``int8_vs_dense_top1_agreement`` keeps
  its name.

Inputs, in the JAX script's draw order from ``np.random.default_rng(0)``:
the (gallery, dim) normal rows normalised to unit rows (floor 1e-12), then
the (iters, batch, dim) normal queries; both are staged on the device. The
int8 gallery is ``ops.matcher.quantize_embeddings_int8`` of the rows, once,
on the device, outside the timing.

Parity, on the first 64 queries of the first batch: the top-1 agreement
of each path with dense and the largest score difference, with the JAX
script's two checks (stream agreement 1.0, int8 score error below 0.02).

Method (``utils/profiling.checksum_rounds``): for each path, one warm-up
run of ``--iters`` batches, then 3 runs of ``--iters`` calls between two
CUDA events (wall clock with ``--device cpu``), the checksum ``sum(scores)
+ sum(idx)·1e-9`` carried on the device and read after each run; the best
run counts.

    python -m facerecognition_tpu_torch.bench_gallery [--gallery 1000000] \\
        [--dim 512] [--batch 256] [--iters 8] [--k 5] [--skip-dense] [--device cpu]

Prints a ``#`` header line, the two parity lines, then one line per path.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from facerecognition_tpu_torch.device import resolve_device
from facerecognition_tpu_torch.ops.int8_topk import int8_topk
from facerecognition_tpu_torch.ops.matcher import cosine_topk, quantize_embeddings_int8
from facerecognition_tpu_torch.ops.stream_topk import stream_topk
from facerecognition_tpu_torch.utils.profiling import checksum_rounds

#: The reference's batched throughput (img/s), the JAX script's baseline.
BASELINE = 1592.0
PARITY_QUERIES = 64
PATHS = ("stream_topk", "int8_topk", "dense_torch")


def draws(gallery: int, dim: int, batch: int, iters: int) -> tuple[np.ndarray, np.ndarray]:
    """The JAX script's inputs from ``default_rng(0)``: the (gallery, dim)
    unit rows, then the (iters, batch, dim) queries, float32."""
    rng = np.random.default_rng(0)
    gal = rng.normal(size=(gallery, dim)).astype(np.float32)
    gal /= np.maximum(np.linalg.norm(gal, axis=1, keepdims=True), 1e-12)
    return gal, rng.normal(size=(iters, batch, dim)).astype(np.float32)


def matchers(gallery: torch.Tensor) -> dict:
    """``{path: matcher(queries, k) -> (scores, int32 indices)}`` over one
    gallery (``PATHS`` order); the int8 codes and scales are made here,
    once."""
    codes, scales = quantize_embeddings_int8(gallery)
    return {
        "stream_topk": lambda q, k: stream_topk(q, gallery, k),
        "int8_topk": lambda q, k: int8_topk(q, codes, scales, k),
        "dense_torch": lambda q, k: cosine_topk(q, gallery, k),
    }


def parity(paths: dict, queries: torch.Tensor, k: int) -> list[dict]:
    """The parity lines of the stream and int8 paths against dense."""
    s_ref, i_ref = (t.cpu() for t in paths["dense_torch"](queries, k))
    lines = []
    for name, metric in (("stream_topk", "stream_vs_dense_top1_agreement"),
                         ("int8_topk", "int8_vs_dense_top1_agreement")):
        s, i = (t.cpu() for t in paths[name](queries, k))
        lines.append({
            "metric": metric,
            "value": float((i_ref[:, 0] == i[:, 0]).double().mean()),
            "unit": "fraction",
            "max_score_err": float((s_ref - s).abs().max()),
        })
    return lines


def main(argv=None) -> dict:
    """Run the bench; returns its record: the parity ``lines`` and the
    timed ``paths`` (each path's JSON line and runs' ms)."""
    import argparse

    ap = argparse.ArgumentParser(description="exact top-k match throughput at the 1M-row regime")
    ap.add_argument("--gallery", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=8, help="batches per timed run")
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--skip-dense", action="store_true", help="skip the dense path (memory-heavy at 1M)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "host"
    print(f"# gallery={args.gallery} dim={args.dim} batch={args.batch} k={args.k} "
          f"device={device} ({name})", flush=True)
    gal_np, queries_np = draws(args.gallery, args.dim, args.batch, args.iters)
    gallery = torch.as_tensor(gal_np, device=device)
    del gal_np
    queries = torch.as_tensor(queries_np, device=device)
    paths = matchers(gallery)

    lines = parity(paths, queries[0][:PARITY_QUERIES], args.k)
    for line in lines:
        print(json.dumps(line), flush=True)
    stream, int8 = lines
    if stream["value"] != 1.0:
        raise AssertionError("stream/dense top-1 mismatch")
    if not int8["max_score_err"] < 0.02:
        raise AssertionError(f"int8 scores off by {int8['max_score_err']} (gallery layout bug?)")

    timed = {}
    for path in PATHS[:2] if args.skip_dense else PATHS:
        match = paths[path]

        def step(carry, i, match=match):
            scores, idx = match(queries[i], args.k)
            return carry + scores.sum() + idx.sum().float() * 1e-9

        runs = checksum_rounds(step, args.iters, device)
        qps = args.iters * args.batch / (min(ms for ms, _ in runs) / 1e3)
        line = {
            "metric": f"gallery_match_qps_{path}_N{args.gallery}",
            "value": round(qps, 1),
            "unit": "queries/s",
            "vs_baseline": round(qps / BASELINE, 2),
        }
        print(json.dumps(line), flush=True)
        timed[path] = {"line": line, "rounds_ms": [ms for ms, _ in runs]}
    return {"lines": lines, "paths": timed}


if __name__ == "__main__":
    main()
