"""Explainability: Grad-CAM for ArcFace and activation-CAM for FaceNet.

Counterpart of ``facerecognition_tpu/inference/explainability.py``. The
models return their CAM feature map (NCHW here; the JAX models' is NHWC),
and the ArcFace model embeds straight from a feature map
(``ArcFaceModel(None, feature_map=f)``), so the gradient of the score with
respect to the map is one ``torch.autograd.grad`` through the embedding
head, under ``torch.enable_grad()`` and ``strict_fp32()`` with the model in
``eval()`` (``Embedder.embed`` runs without gradients and is not used):

- Grad-CAM: score = cosine(embedding, target) with a target embedding,
  else ||embedding||²; CAM = ReLU(Σ_c w_c · A_c), w the spatial mean of
  ∂score/∂A.
- Activation-CAM (FaceNet, whose gradients vanish through the output's L2
  normalisation): Σ_c |A_c| of the ``block8`` map.

Each CAM is resized to the face's size and scaled to [0, 1];
``cam_to_heatmap`` and ``overlay_heatmap`` draw it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from facerecognition_tpu_torch.device import strict_fp32
from facerecognition_tpu_torch.ops.image import align_crop, bilinear_resize, normalize_imagenet_style
from facerecognition_tpu_torch.utils.imageio import load_image


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _model_input(model: torch.nn.Module, image: np.ndarray) -> torch.Tensor:
    img = torch.as_tensor(np.asarray(image, np.float32), device=_device(model))
    return normalize_imagenet_style(img)[None]


def _scaled_cam(cam: torch.Tensor, size: int) -> np.ndarray:
    """(h, w) CAM → (size, size) bilinear, then min-max scaled to [0, 1]
    (all zeros when flat)."""
    cam = bilinear_resize(cam.detach().float(), size, size).cpu().numpy()
    lo, hi = cam.min(), cam.max()
    return (cam - lo) / (hi - lo) if hi > lo else np.zeros_like(cam)


class GradCAM:
    """Grad-CAM over a model with the feature-map re-entry: ``model(x,
    return_feature_map=True)`` gives (embedding, NCHW map) and
    ``model(None, feature_map=f)`` the embedding from ``f``."""

    def __init__(self, model: torch.nn.Module):
        self.model = model

    def generate(
        self,
        image: np.ndarray,
        target_embedding: Optional[np.ndarray] = None,
        out_size: Optional[int] = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """image: (S, S, 3) uint8/float in [0, 255] (an aligned crop).
        Returns (cam (out, out) in [0, 1], embedding (D,))."""
        model = self.model.eval()
        x = _model_input(model, image)
        with torch.no_grad(), strict_fp32():
            emb, fmap = model(x, return_feature_map=True)
        fmap = fmap.detach().requires_grad_(True)
        with torch.enable_grad(), strict_fp32():
            e = model(None, feature_map=fmap)
            if target_embedding is None:
                score = torch.sum(e * e)
            else:
                t = np.asarray(target_embedding, np.float32).reshape(1, -1)
                t = torch.as_tensor(t / max(np.linalg.norm(t), 1e-12), device=e.device)
                e = e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True), min=1e-12)
                score = torch.sum(e * t)
            (grads,) = torch.autograd.grad(score, fmap)
        weights = grads.mean(dim=(2, 3), keepdim=True)
        cam = torch.relu(torch.sum(weights * fmap.detach(), dim=1))[0]
        return _scaled_cam(cam, out_size or image.shape[0]), emb[0].cpu().numpy()


class ActivationCAM:
    """Gradient-free CAM: the channel sum of |activation| of the model's
    feature map (``model(x, return_feature_map=True)``)."""

    def __init__(self, model: torch.nn.Module):
        self.model = model

    @torch.no_grad()
    def generate(self, image: np.ndarray, out_size: Optional[int] = None) -> tuple[np.ndarray, np.ndarray]:
        model = self.model.eval()
        with strict_fp32():
            emb, fmap = model(_model_input(model, image), return_feature_map=True)
        cam = fmap.abs().sum(dim=1)[0]
        return _scaled_cam(cam, out_size or image.shape[0]), emb[0].cpu().numpy()


def cam_to_heatmap(cam: np.ndarray) -> np.ndarray:
    """[0, 1] CAM → RGB uint8 jet-style heatmap."""
    c = np.clip(cam, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * c - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * c - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * c - 1), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def overlay_heatmap(image: np.ndarray, cam: np.ndarray, alpha: float = 0.45) -> np.ndarray:
    """The CAM's heatmap alpha-blended onto the image (resized to the CAM's
    size first when they differ): RGB uint8."""
    heat = cam_to_heatmap(cam).astype(np.float32)
    img = np.asarray(image, np.float32)
    if img.shape[:2] != heat.shape[:2]:
        img = bilinear_resize(torch.from_numpy(img), heat.shape[0], heat.shape[1]).numpy()
    out = (1 - alpha) * img + alpha * heat
    return np.clip(out, 0, 255).astype(np.uint8)


class ExplainabilityEngine:
    """ArcFace explanations: load → detect and align (with a detector) →
    Grad-CAM → heatmap and overlay, on the embedder's device."""

    def __init__(self, embedder, detector=None):
        self.embedder = embedder
        self.detector = detector
        self.gradcam = GradCAM(embedder.model)

    def _prepare(self, img_input) -> Optional[np.ndarray]:
        """The face the CAM explains: the detector's face aligned to the
        embedder's input size (its landmarks' Umeyama warp), else the whole
        image resized to it."""
        img = load_image(img_input)
        size = self.embedder.config.input_size
        dev = self.embedder.device
        if self.detector is not None:
            det = self.detector.detect(img)
            if det is not None and det.get("landmarks") is not None:
                return align_crop(
                    torch.as_tensor(np.asarray(img, np.float32), device=dev),
                    torch.as_tensor(np.asarray(det["landmarks"], np.float32), device=dev),
                    size,
                ).cpu().numpy()
        if img.shape[0] != size or img.shape[1] != size:
            return bilinear_resize(torch.as_tensor(np.asarray(img, np.float32), device=dev),
                                   size, size).cpu().numpy()
        return np.asarray(img)

    def _result(self, face: np.ndarray, cam: np.ndarray, emb: np.ndarray) -> dict:
        return {
            "cam": cam,
            "heatmap": cam_to_heatmap(cam),
            "overlay": overlay_heatmap(face, cam),
            "embedding": emb,
            "face": np.clip(face, 0, 255).astype(np.uint8),
        }

    def explain(self, img_input, target_embedding: Optional[np.ndarray] = None) -> Optional[dict]:
        """{'cam', 'heatmap', 'overlay', 'embedding', 'face'}; the CAM of
        the cosine with ``target_embedding`` when given."""
        face = self._prepare(img_input)
        if face is None:
            return None
        cam, emb = self.gradcam.generate(face, target_embedding)
        return self._result(face, cam, emb)


class FaceNetExplainabilityEngine(ExplainabilityEngine):
    """FaceNet explanations by activation-CAM (``target_embedding`` is
    ignored: no gradients)."""

    def __init__(self, embedder, detector=None):
        self.embedder = embedder
        self.detector = detector
        self.cam_engine = ActivationCAM(embedder.model)

    def explain(self, img_input, target_embedding=None) -> Optional[dict]:
        face = self._prepare(img_input)
        if face is None:
            return None
        cam, emb = self.cam_engine.generate(face)
        return self._result(face, cam, emb)
