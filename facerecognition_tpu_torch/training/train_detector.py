"""Detector training: anchor matching, the focal + smooth-L1 loss, the train
step, the scene curriculum, evaluation and score calibration.

Counterpart of ``facerecognition_tpu/training/train_detector.py``:

- ``assign_targets`` matches anchors to the padded ground-truth faces of a
  batch (IoU > 0.5, plus each face's best anchor, forced), as the JAX
  function under ``vmap``; ``detection_loss`` is the focal sigmoid
  cross-entropy plus smooth-L1 box and landmark regression on positives;
- ``make_detector_train_step`` differentiates it through the port's
  ``BlazeFaceNet``/``DenseDetNet`` and applies Adam (``training/optim``);
- ``train_detector_curriculum`` renders ``synthetic_faces.scene_batch`` in
  producer threads (the renderer releases the GIL in ``training/raster``)
  and trains on the card from uint8 batches normalised there;
- ``evaluate_detector`` and ``fit_score_calibration`` run
  ``FaceDetector.detect_all`` (the ``detect_post`` kernel on the card) on
  held-out scenes;
- ``synthetic_face_batch`` is the older generator, numpy only, so the
  realtime app's ``SyntheticFrameSource`` draws the same frames as the JAX
  package's for the same seed.

Random initialisation is flax's (``models/layers.init_like_flax``: LeCun
truncated-normal kernels, zero biases) from a ``torch.Generator``, not
flax's numbers. Entry points take ``device=None``, the card.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from facerecognition_tpu_torch.device import DeviceLike, resolve_device, strict_fp32
from facerecognition_tpu_torch.models.detector_net import anchor_centers, build_detector_net
from facerecognition_tpu_torch.models.layers import init_like_flax
from facerecognition_tpu_torch.ops.nms import iou_matrix
from facerecognition_tpu_torch.training.optim import OptaxChain
from facerecognition_tpu_torch.training.schedules import warmup_cosine_decay
from facerecognition_tpu_torch.training.steps import TrainState, apply_gradients

MAX_GT = 4  # static per-image ground-truth face slots


def _np_iou(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """IoU of one xyxy box against (N, 4) boxes."""
    ix = np.maximum(0.0, np.minimum(box[2], boxes[:, 2]) - np.maximum(box[0], boxes[:, 0]))
    iy = np.maximum(0.0, np.minimum(box[3], boxes[:, 3]) - np.maximum(box[1], boxes[:, 1]))
    inter = ix * iy
    area = (box[2] - box[0]) * (box[3] - box[1])
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.maximum(area + areas - inter, 1e-9)


def anchor_default_boxes(anchors: torch.Tensor) -> torch.Tensor:
    """(A, 4) xyxy default boxes: base x base squares at anchor centers."""
    cx, cy, s = anchors[:, 0], anchors[:, 1], anchors[:, 2]
    return torch.stack([cx - s / 2, cy - s / 2, cx + s / 2, cy + s / 2], -1)


def assign_targets(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_landmarks: torch.Tensor,
    gt_valid: torch.Tensor,
) -> dict:
    """Match anchors to a batch of padded GT faces.

    Args:
      anchors: (A, 3) [cx, cy, base].
      gt_boxes: (B, MAX_GT, 4) xyxy (padding rows arbitrary).
      gt_landmarks: (B, MAX_GT, 5, 2).
      gt_valid: (B, MAX_GT) bool.

    Returns dict of cls (B, A) float {0, 1}, reg (B, A, 14) regression
    targets and pos (B, A) bool. An anchor is positive if its IoU with a
    valid GT is > 0.5, or if it is the best anchor of a valid GT (every GT
    gets a positive); a forced anchor adopts its GT. Padding GTs force
    nothing. Two GTs with the same best anchor: the later GT takes it, as
    XLA's scatter on the CPU gives it.
    """
    bsz, n_gt = gt_valid.shape
    n_anchor = anchors.shape[0]
    boxes_a = anchor_default_boxes(anchors)
    iou = iou_matrix(boxes_a.expand(bsz, -1, -1), gt_boxes)  # (B, A, G)
    iou = torch.where(gt_valid[:, None, :], iou, torch.zeros((), dtype=iou.dtype, device=iou.device))
    best_iou = torch.amax(iou, dim=2)
    best_gt = torch.argmax(iou, dim=2)  # first maximum, as jnp.argmax
    best_anchor = torch.argmax(iou, dim=1)  # (B, G)
    forced = torch.zeros(bsz, n_anchor, dtype=torch.bool, device=iou.device)
    forced_gt = torch.zeros(bsz, n_anchor, dtype=torch.int64, device=iou.device)
    for g in range(n_gt):  # in GT order: a later GT overwrites an earlier one
        idx = best_anchor[:, g : g + 1]
        ok = gt_valid[:, g : g + 1]
        forced.scatter_(1, idx, forced.gather(1, idx) | ok)
        forced_gt.scatter_(1, idx, torch.where(ok, g, forced_gt.gather(1, idx)))
    pos = (best_iou > 0.5) | forced
    gt_idx = torch.where(forced, forced_gt, best_gt)

    g = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(-1, -1, 4))  # (B, A, 4)
    g_lm = torch.gather(gt_landmarks, 1, gt_idx[..., None, None].expand(-1, -1, 5, 2))
    cx, cy, s = anchors[:, 0], anchors[:, 1], anchors[:, 2]
    g_cx = (g[..., 0] + g[..., 2]) / 2
    g_cy = (g[..., 1] + g[..., 3]) / 2
    g_w = torch.clamp(g[..., 2] - g[..., 0], min=1e-3)
    g_h = torch.clamp(g[..., 3] - g[..., 1], min=1e-3)
    half = 0.5 * s
    reg = torch.cat(
        [
            ((g_cx - cx) / half)[..., None],
            ((g_cy - cy) / half)[..., None],
            torch.log(g_w / s)[..., None],
            torch.log(g_h / s)[..., None],
            ((g_lm - torch.stack([cx, cy], -1)[:, None, :]) / half[:, None, None]).reshape(bsz, -1, 10),
        ],
        dim=-1,
    )
    return {"cls": pos.to(torch.float32), "reg": reg, "pos": pos}


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def detection_loss(
    raw: torch.Tensor, targets: dict, focal_gamma: float = 2.0, alpha: float = 0.25
) -> tuple[torch.Tensor, dict]:
    """Focal sigmoid CE over all anchors + smooth-L1 on positives, per
    image, then the batch mean (JAX's ``vmap`` of the per-image loss and
    ``jnp.mean``).

    raw: (B, A, 15); targets from :func:`assign_targets`. Returns (loss,
    metrics of ``cls_loss``, ``reg_loss``, ``n_pos``, each a batch mean).
    """
    logits = raw[..., 0]
    p = torch.sigmoid(logits)
    cls_t = targets["cls"]
    is_pos = cls_t > 0.5
    pt = torch.where(is_pos, p, 1.0 - p)
    alpha_t = torch.where(is_pos, alpha, 1.0 - alpha)
    bce = -torch.log(torch.clamp(pt, 1e-7, 1.0))
    focal = alpha_t * (1.0 - pt) ** focal_gamma * bce
    posf = targets["pos"].to(torch.float32)
    n_pos = torch.clamp(torch.sum(posf, dim=1), min=1.0)
    cls_loss = torch.sum(focal, dim=1) / n_pos
    reg_err = smooth_l1(raw[..., 1:15] - targets["reg"])
    reg_loss = torch.sum(reg_err * posf[..., None], dim=(1, 2)) / n_pos
    loss = cls_loss + 2.0 * reg_loss
    metrics = {"cls_loss": cls_loss.mean(), "reg_loss": reg_loss.mean(), "n_pos": n_pos.mean()}
    return loss.mean(), metrics


def _named_params(net: torch.nn.Module) -> dict:
    return dict(net.named_parameters())


def detector_train_state(net: torch.nn.Module, schedule: Callable[[int], float]) -> TrainState:
    """``TrainState.create(..., tx=optax.adam(schedule))`` of ``net``."""
    return TrainState(net, OptaxChain(_named_params(net), "adam", schedule))


def make_detector_train_step(net: torch.nn.Module, anchors: torch.Tensor) -> Callable:
    """A step over batches of (images, gt_boxes, gt_lms, gt_valid) on the
    net's device: images (B, S, S, 3) normalised to [-1, 1]; returns the
    metrics (``loss``, ``cls_loss``, ``reg_loss``, ``n_pos``) as 0-d tensors
    and updates ``state`` in place. The net has no dropout or batch norm,
    so its mode does not matter."""
    names = list(_named_params(net))

    def gradients(state: TrainState, images, gt_boxes, gt_lms, gt_valid):
        model = state.model
        with strict_fp32():
            raw = model(images)
            targets = assign_targets(anchors, gt_boxes, gt_lms, gt_valid)
            loss, metrics = detection_loss(raw, targets)
            params = dict(model.named_parameters())
            grads = torch.autograd.grad(loss, [params[n] for n in names])
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return dict(zip(names, grads)), metrics

    def step(state: TrainState, images, gt_boxes, gt_lms, gt_valid):
        grads, metrics = gradients(state, images, gt_boxes, gt_lms, gt_valid)
        apply_gradients(state, grads)
        return metrics

    step.gradients = gradients
    return step


def init_detector_net(arch: str, seed: int) -> torch.nn.Module:
    """A ``build_detector_net(arch)`` initialised as flax initialises it
    (LeCun truncated-normal kernels, zero biases), from a ``torch.Generator``
    seeded with ``seed``, on the CPU."""
    return init_like_flax(build_detector_net(arch), torch.Generator().manual_seed(seed))


def net_variables(net: torch.nn.Module) -> dict:
    """The net's weights as flax ``{"params": ...}`` numpy arrays (what
    ``utils.serialization.save_variables`` writes and ``FaceDetector`` loads)."""
    from facerecognition_tpu_torch.convert import state_dict_to_flax

    return {"params": state_dict_to_flax(net.state_dict())["params"]}


def synthetic_face_batch(
    rng: np.random.Generator,
    batch: int,
    size: int = 128,
    p_face: float = 0.9,
    max_per_image: int = 1,
):
    """Procedural 'faces': skin ellipse + eyes/nose/mouth landmarks on noise.

    Places 1..max_per_image non-overlapping faces per image (w.p. p_face).
    Returns (images (B, S, S, 3) f32, gt_boxes (B, MAX_GT, 4),
    gt_lms (B, MAX_GT, 5, 2), gt_valid (B, MAX_GT) bool), drawing from
    ``rng`` in the JAX generator's order.
    """
    assert max_per_image <= MAX_GT
    imgs = rng.integers(0, 90, (batch, size, size, 3)).astype(np.float32)
    boxes = np.zeros((batch, MAX_GT, 4), np.float32)
    lms = np.zeros((batch, MAX_GT, 5, 2), np.float32)
    valid = np.zeros((batch, MAX_GT), bool)
    yy, xx = np.mgrid[0:size, 0:size]
    for b in range(batch):
        if rng.random() > p_face:
            continue
        # (no draw when single-face, which keeps the RNG stream stable)
        n_faces = 1 if max_per_image == 1 else int(rng.integers(1, max_per_image + 1))
        slot = 0
        for _ in range(n_faces * 4):  # rejection-sample placements
            if slot >= n_faces:
                break
            rmax = size * (0.3 if n_faces == 1 else 0.18)
            r = rng.uniform(size * 0.12, rmax)
            cx = rng.uniform(r + 2, size - r - 2)
            cy = rng.uniform(r + 2, size - r - 2)
            box = np.array([cx - r, cy - 1.25 * r, cx + r, cy + 1.25 * r])
            if slot and _np_iou(box, boxes[b, :slot]).max() > 0.05:
                continue
            skin = np.array([rng.uniform(170, 230), rng.uniform(120, 180), rng.uniform(90, 140)])
            mask = ((xx - cx) / r) ** 2 + ((yy - cy) / (1.25 * r)) ** 2 <= 1.0
            imgs[b][mask] = skin + rng.normal(0, 6, 3)
            # landmarks in the canonical face layout
            eye_y = cy - 0.35 * r
            lm = np.array([
                [cx - 0.45 * r, eye_y],
                [cx + 0.45 * r, eye_y],
                [cx, cy + 0.15 * r],
                [cx - 0.35 * r, cy + 0.65 * r],
                [cx + 0.35 * r, cy + 0.65 * r],
            ])
            for k, (lx, ly) in enumerate(lm):
                ix, iy = int(lx), int(ly)
                rad = max(1, int(r * 0.1))
                m2 = (xx - ix) ** 2 + (yy - iy) ** 2 <= rad * rad
                imgs[b][m2] = 25.0 if k < 2 else (80.0 if k == 2 else 50.0)
            boxes[b, slot] = box
            lms[b, slot] = lm
            valid[b, slot] = True
            slot += 1
    return imgs, boxes, lms, valid


@dataclasses.dataclass
class DetectorTrainConfig:
    input_size: int = 128
    batch_size: int = 32
    steps: int = 500
    lr: float = 1e-3
    seed: int = 0
    max_faces_per_image: int = 1


@dataclasses.dataclass
class CurriculumConfig:
    """Config for curriculum training on the v2 procedural scenes
    (`training.synthetic_faces`)."""

    input_size: int = 128
    batch_size: int = 64
    steps: int = 4000
    lr: float = 1.5e-3
    warmup: int = 200
    seed: int = 0
    max_faces: int = 2
    p_face: float = 0.92
    prefetch_threads: int = 4
    arch: str = "blaze"  # see models.detector_net.DETECTOR_ARCHS
    ranges: str = "v3"  # see synthetic_faces.SCENE_RANGES (v4 = wide OOD)


def normalize_u8(images: torch.Tensor) -> torch.Tensor:
    """A uint8 batch as the detector's input: ``x / 127.5 - 1`` in float32."""
    return images.to(torch.float32) / 127.5 - 1.0


def train_detector_curriculum(
    config: CurriculumConfig,
    log_every: int = 200,
    progress: Optional[Callable[[int, float], None]] = None,
    init_variables: Optional[dict] = None,
    device: DeviceLike = None,
    timings: Optional[dict] = None,
):
    """Train the detector on the v2 scene curriculum (varied faces, poses,
    backgrounds, hard negatives; see `synthetic_faces.render_scene`).

    Scenes are rendered in ``prefetch_threads`` producer threads, each from
    ``np.random.default_rng((seed, tid))`` into a queue of two batches of
    its own; step ``i`` takes the next batch of thread ``i % prefetch_threads``,
    so the batches and their order follow from the seed, whatever the
    threads' timing (JAX's trainer takes whichever batch is ready first).
    A batch crosses to the card as uint8
    (truncated from the float scene, as the JAX trainer's
    ``astype(np.uint8)``) and is normalised there. A producer that raises
    stops training with ``RuntimeError`` (chained to its error), as does the
    end of all producers. ``init_variables`` (flax ``{"params": ...}``)
    warm-starts from an earlier checkpoint with a fresh optimizer and
    schedule: Adam on ``warmup_cosine_decay(0, lr, warmup, steps)``, warmup
    ``min(warmup, max(steps // 10, 1))``. ``timings``, when given, receives
    ``wait_s`` (per step, the host's wait on the queue) and, on the card,
    ``events`` (per step, CUDA events before the upload and after the
    update). Returns (variables, history).
    """
    from facerecognition_tpu_torch.convert import load_flax_variables
    from facerecognition_tpu_torch.training.synthetic_faces import SCENE_RANGES, scene_batch

    dev = resolve_device(device)
    scene_ranges = SCENE_RANGES[config.ranges]
    net = init_detector_net(config.arch, config.seed)
    if init_variables is not None:
        load_flax_variables(net, {"params": init_variables["params"]})
    net = net.to(dev).train()
    anchors = torch.as_tensor(anchor_centers(config.input_size), device=dev)
    warmup = min(config.warmup, max(config.steps // 10, 1))
    state = detector_train_state(net, warmup_cosine_decay(0.0, config.lr, warmup, config.steps))
    step_fn = make_detector_train_step(net, anchors)

    queues: "list[queue.Queue]" = [queue.Queue(maxsize=2) for _ in range(config.prefetch_threads)]
    stop = threading.Event()
    producer_errors: list[BaseException] = []

    def producer(tid: int) -> None:
        rng = np.random.default_rng((config.seed, tid))
        try:
            while not stop.is_set():
                batch = scene_batch(
                    rng,
                    config.batch_size,
                    config.input_size,
                    config.max_faces,
                    config.p_face,
                    ranges=scene_ranges,
                )
                while not stop.is_set():
                    try:
                        queues[tid].put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as exc:  # surface instead of a silent hang
            producer_errors.append(exc)

    threads = [
        threading.Thread(target=producer, args=(t,), daemon=True)
        for t in range(config.prefetch_threads)
    ]
    for t in threads:
        t.start()
    on_card = dev.type == "cuda"
    if timings is not None:
        timings.setdefault("wait_s", [])
        if on_card:
            timings.setdefault("events", [])
    history = []
    try:
        for step in range(config.steps):
            t0 = time.perf_counter()
            tid = step % config.prefetch_threads
            while True:
                try:
                    imgs, gb, gl, gv = queues[tid].get(timeout=2.0)
                    break
                except queue.Empty:
                    if producer_errors:
                        raise RuntimeError("scene producer thread died") from producer_errors[0]
                    if not threads[tid].is_alive():
                        raise RuntimeError(f"scene producer thread {tid} exited")
            if timings is not None:
                timings["wait_s"].append(time.perf_counter() - t0)
                if on_card:
                    ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                    ev[0].record()
            metrics = step_fn(
                state,
                normalize_u8(torch.from_numpy(imgs.astype(np.uint8)).to(dev, non_blocking=True)),
                torch.from_numpy(gb).to(dev),
                torch.from_numpy(gl).to(dev),
                torch.from_numpy(gv).to(dev),
            )
            if timings is not None and on_card:
                ev[1].record()
                timings["events"].append(ev)
            if step % log_every == 0 or step == config.steps - 1:
                loss = float(metrics["loss"])
                history.append({"step": step, "loss": loss})
                if progress is not None:
                    progress(step, loss)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=2.0)
    return net_variables(net), history


def evaluate_detector(
    detector,
    n_scenes: int = 200,
    seed: int = 777,
    size: Optional[int] = None,
    max_faces: int = 2,
    iou_match: float = 0.5,
    ranges=None,
) -> dict:
    """Detection quality on held-out v2 scenes: recall@IoU, mean matched
    IoU, landmark error (fraction of face width), false positives/image.
    ``ranges`` (a synthetic_faces.SceneRanges, or a tuple to draw from per
    scene) selects the sampling envelope; default v3. Each scene goes to
    ``detector.detect_all`` truncated to uint8."""
    from facerecognition_tpu_torch.training.synthetic_faces import render_scene

    rng = np.random.default_rng(seed)
    size = size or detector.input_size
    n_gt = n_match = n_fp = 0
    iou_sum = 0.0
    lm_err_sum = 0.0
    pool = ranges if isinstance(ranges, (tuple, list)) else None
    for _ in range(n_scenes):
        rr = pool[int(rng.integers(0, len(pool)))] if pool else ranges
        img, gt_boxes, gt_lms, gt_valid = render_scene(
            rng, size, max_faces, p_face=0.92, ranges=rr
        )
        dets = detector.detect_all(img.astype(np.uint8))
        gt = gt_boxes[gt_valid]
        glm = gt_lms[gt_valid]
        n_gt += len(gt)
        taken = np.zeros(len(gt), bool)
        for d in dets:
            db = np.asarray(d["bbox"], np.float32)
            if len(gt) == 0:
                n_fp += 1
                continue
            ious = _np_iou(db, gt)
            ious = np.where(taken, 0.0, ious)
            j = int(np.argmax(ious))
            if ious[j] >= iou_match:
                taken[j] = True
                n_match += 1
                iou_sum += float(ious[j])
                if d.get("landmarks") is not None:
                    w = gt[j, 2] - gt[j, 0]
                    lm_err_sum += float(
                        np.linalg.norm(np.asarray(d["landmarks"]) - glm[j], axis=1).mean()
                        / max(w, 1e-6)
                    )
            else:
                n_fp += 1
    return {
        "recall": n_match / max(n_gt, 1),
        "mean_iou": iou_sum / max(n_match, 1),
        "mean_lm_err_frac": lm_err_sum / max(n_match, 1),
        "fp_per_image": n_fp / n_scenes,
        "n_gt": n_gt,
    }


def fit_score_calibration(
    detector,
    n_scenes: int = 300,
    seed: int = 555,
    max_faces: int = 2,
    iou_match: float = 0.5,
    ranges=None,
) -> tuple[float, float]:
    """Platt-scale the detector's confidence on held-out scenes.

    Focal-loss training (γ=2) deflates raw sigmoid scores. Fit
    ``p = σ(a·z + b)`` (z = raw logit) by logistic regression (IRLS in
    numpy) on TP/FP labels of candidate detections above 0.02, with the
    detector's threshold and calibration set aside meanwhile and restored
    after (also on error). Returns (a, b); apply via the FaceDetector
    checkpoint key ``calibration``.
    """
    from facerecognition_tpu_torch.training.synthetic_faces import render_scene

    rng = np.random.default_rng(seed)
    old_thr = detector.confidence_threshold
    old_cal = getattr(detector, "_calibration", None)
    detector.confidence_threshold = 0.02
    detector._calibration = None  # fit on RAW scores
    zs, ys = [], []
    try:
        pool = ranges if isinstance(ranges, (tuple, list)) else None
        for _ in range(n_scenes):
            rr = pool[int(rng.integers(0, len(pool)))] if pool else ranges
            img, gt_boxes, _, gt_valid = render_scene(
                rng, detector.input_size, max_faces, p_face=0.8, ranges=rr
            )
            gt = gt_boxes[gt_valid]
            taken = np.zeros(len(gt), bool)
            for d in detector.detect_all(img.astype(np.uint8)):
                s = min(max(d["confidence"], 1e-6), 1.0 - 1e-6)
                z = float(np.log(s / (1.0 - s)))
                tp = False
                if len(gt):
                    ious = _np_iou(np.asarray(d["bbox"], np.float32), gt)
                    ious = np.where(taken, 0.0, ious)
                    j = int(np.argmax(ious))
                    if ious[j] >= iou_match:
                        taken[j] = True
                        tp = True
                zs.append(z)
                ys.append(1.0 if tp else 0.0)
    finally:
        detector.confidence_threshold = old_thr
        detector._calibration = old_cal
    z = np.asarray(zs)
    y = np.asarray(ys)
    # 2-param logistic regression by IRLS from (1, 0), at most 50 steps.
    a, b = 1.0, 0.0
    for _ in range(50):
        p = 1.0 / (1.0 + np.exp(-(a * z + b)))
        w = np.maximum(p * (1.0 - p), 1e-6)
        g = np.array([np.sum((p - y) * z), np.sum(p - y)])
        H = np.array(
            [
                [np.sum(w * z * z) + 1e-6, np.sum(w * z)],
                [np.sum(w * z), np.sum(w) + 1e-6],
            ]
        )
        da, db = np.linalg.solve(H, g)
        a, b = a - da, b - db
        if abs(da) + abs(db) < 1e-8:
            break
    return float(a), float(b)


def train_detector_synthetic(
    config: DetectorTrainConfig,
    log_every: int = 100,
    progress: Optional[Callable[[int, float], None]] = None,
    device: DeviceLike = None,
):
    """Train BlazeFaceNet on ``synthetic_face_batch`` faces with Adam at a
    constant ``lr``; returns (variables, history)."""
    dev = resolve_device(device)
    net = init_detector_net("blaze", config.seed).to(dev).train()
    anchors = torch.as_tensor(anchor_centers(config.input_size), device=dev)
    rng = np.random.default_rng(config.seed)
    state = detector_train_state(net, lambda count: config.lr)
    step_fn = make_detector_train_step(net, anchors)
    history = []
    for step in range(config.steps):
        imgs, gb, gl, gv = synthetic_face_batch(
            rng,
            config.batch_size,
            config.input_size,
            max_per_image=config.max_faces_per_image,
        )
        norm = torch.from_numpy(imgs).to(dev) / 127.5 - 1.0
        metrics = step_fn(
            state, norm, torch.from_numpy(gb).to(dev), torch.from_numpy(gl).to(dev),
            torch.from_numpy(gv).to(dev),
        )
        if step % log_every == 0 or step == config.steps - 1:
            loss = float(metrics["loss"])
            history.append({"step": step, "loss": loss})
            if progress is not None:
                progress(step, loss)
    return net_variables(net), history
