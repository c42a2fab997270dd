"""The design of the ``detect_post`` kernel's selection, checked on the CPU.

``csrc/detect_post.cu`` keeps a frame's keys in registers (anchor k·G + g in
thread g of a group of G = 32·W threads), radix-selects the K-th largest key
two bits at a time, keeps the lowest anchors among keys equal to it (a walk
in anchor order for one warp, a select over the anchor bits for a group),
orders the K survivors as 64-bit
(key, ~anchor) words by a bitonic network, and runs the greedy NMS in that
order (its argmax of the live scores, first maximum, is the first live
candidate). ``select_and_sort`` below is that procedure in numpy, step for step;
with the plain NMS after it, it must give ``detect_faces_batch``'s outputs
bit for bit, so a wrong design fails here before it reaches the card.
"""

import numpy as np
import pytest
import torch

from facerecognition_tpu_torch.models.detector_net import (
    anchor_centers,
    decode_predictions,
    detect_faces_batch,
    prefilter_size,
)
from facerecognition_tpu_torch.ops.matcher import order_key, topk_lowest_index
from facerecognition_tpu_torch.ops.nms import iou_matrix


def select_and_sort(scores: torch.Tensor, k: int, warps: int = 1) -> np.ndarray:
    """One frame's (A,) scores → the K anchors, key descending, anchor
    ascending, as the kernel finds and orders them."""
    a_n = scores.shape[0]
    g = 32 * warps
    slots = -(-a_n // g) * g
    u = np.zeros(slots, np.uint64)  # padding: 0, below every key
    u[:a_n] = (order_key(scores).numpy().view(np.uint32) ^ np.uint32(0x80000000)).astype(np.uint64)
    anchor = np.arange(slots)
    # radix select, two bits at a time from the top: the K-th largest key t
    t = 0
    for bit in range(30, -1, -2):
        n1, n2, n3 = (int((u >= (t | (d << bit))).sum()) for d in (1, 2, 3))
        t = t | (3 << bit) if n3 >= k else t | (2 << bit) if n2 >= k else t | (1 << bit) if n1 >= k else t
    need = k - int((u > t).sum())
    amax = slots
    if int((u == t).sum()) > need:  # too many ties: the lowest anchors win
        v = 0
        for bit in range(14, -1, -1):
            c = v | (1 << bit)
            if int(((u == t) & (anchor < c)).sum()) < need:
                v = c
        amax = v
        if warps == 1:  # one warp walks its keys in (k, lane) order instead
            walk = np.argsort((anchor // g) * g + anchor % g)
            assert amax == walk[(u[walk] == t)][need - 1]
    keep = (u > t) | ((u == t) & (anchor <= amax))
    assert int(keep.sum()) == k
    # compaction: a warp writes each thread's survivors as one run, thread
    # by thread; a group of warps in the order its atomics take (any)
    lane_major = np.argsort((anchor % g) * slots + anchor // g)
    order = lane_major if warps == 1 else np.random.default_rng(warps).permutation(slots)
    kept = order[keep[order]]
    words = (u[kept] << np.uint64(32)) | (~anchor[kept].astype(np.uint64) & np.uint64(0xFFFFFFFF))
    # bitonic network over N = E·G words, descending; padding 0 sorts last
    e = 1
    while e * g < k:
        e *= 2
    n = e * g
    arr = np.zeros(n, np.uint64)
    arr[:k] = words
    r = np.arange(n)
    size = 2
    while size <= n:
        j = size // 2
        while j > 0:
            other = arr[r ^ j]
            keep_max = ((r & size) == 0) == ((r & j) == 0)
            arr = np.where(keep_max, np.maximum(arr, other), np.minimum(arr, other))
            j //= 2
        size *= 2
    out = arr[:k]
    return (~out & np.uint64(0xFFFFFFFF)).astype(np.int64)


def kernel_post(raw, anchors, iou_threshold, max_faces, warps=1):
    """The kernel's post-process of each frame, in the order it runs."""
    scores, boxes, landmarks = decode_predictions(raw, anchors)
    k = prefilter_size(scores.shape[1], max_faces)
    outs = []
    for f in range(raw.shape[0]):
        cand = torch.as_tensor(select_and_sort(scores[f], k, warps))
        s, b = scores[f, cand], boxes[f, cand]
        live = torch.where(s > 0, s, torch.tensor(float("-inf")))
        iou = iou_matrix(b, b)
        picks = []
        for _ in range(max_faces):
            alive = (live > 0).nonzero()
            if len(alive) == 0:
                break
            # the kernel's pick: the first live candidate, which in this
            # order is the argmax of the live scores, first maximum
            best = int(alive[0])
            assert best == int(torch.argmax(live))
            picks.append(best)
            live = torch.where((iou[best] >= iou_threshold) | (torch.arange(k) == best),
                               torch.tensor(float("-inf")), live)
        slot = picks + [0] * (max_faces - len(picks))
        valid = torch.arange(max_faces) < len(picks)
        outs.append((b[slot], landmarks[f, cand[slot]], torch.where(valid, s[slot], 0.0), valid))
    return tuple(torch.stack(x) for x in zip(*outs))


def _raw(rng, b, a):
    raw = (rng.normal(size=(b, a, 15)) * 2.0).astype(np.float32)
    raw[..., 0] = (rng.normal(size=(b, a)) * 6.0).astype(np.float32)
    raw[0, a // 8 : a // 8 + 60, 0] = rng.uniform(20.0, 40.0, min(60, a - a // 8))
    raw[1, :, 0] = 30.0  # every sigmoid 1.0f: the anchor select decides
    raw[2, 5, 0] = np.nan  # NaN ranks above +inf and is never live
    raw[2, 17, 0] = np.nan
    raw[3, :, 0] = np.nan  # no live candidate
    return torch.as_tensor(raw)


@pytest.mark.parametrize("warps", [1, 2, 4])
@pytest.mark.parametrize(
    "n_anchors, max_faces",
    [(896, 4), (896, 16), (896, 64), (48, 16), (40, 4), (3584, 16)],
    ids=["A896-M4", "A896-M16", "A896-M64", "K=A=48", "K=A=40", "A3584-M16"],
)
def test_kernel_selection_gives_detect_faces_batch(rng, warps, n_anchors, max_faces):
    side = 256 if n_anchors == 3584 else 128
    anchors = torch.as_tensor(anchor_centers(side)[:n_anchors])
    raw = _raw(rng, 5, anchors.shape[0])
    got = kernel_post(raw, anchors, 0.3, max_faces, warps)
    ref = detect_faces_batch(raw, anchors, 0.3, max_faces)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    assert not ref[3][3].any()  # the frame of NaN logits


@pytest.mark.parametrize("warps", [1, 4])
def test_select_order_is_lax_top_k_order(rng, warps):
    """The survivors and their order are ``topk_lowest_index``'s (value
    descending, index ascending, NaN above +inf), ties and all."""
    scores = torch.sigmoid(_raw(rng, 4, 896)[..., 0])
    scores[0, 300:310] = float("nan")
    for k in (1, 64, 128, 896):
        _, ref = topk_lowest_index(scores, k)
        for f in range(scores.shape[0]):
            np.testing.assert_array_equal(select_and_sort(scores[f], k, warps), ref[f].numpy())
