"""The port's example drivers: ``evaluate_model`` (one backend through the
engine and ``inference.evaluate``) and ``compare_all_models`` (ArcFace,
FaceNet and LBPH side by side). Run as ``python -m
facerecognition_tpu_torch.examples.<name>``."""
