"""The port's operational scripts and drivers: label maps, checkpoint
inspection, training-log plots, identity folders, the weight exporters,
the detector trainers' drivers and the evaluations (OOD, int8 agreement,
LBPH at scale, FaceNet A/B). Each runs as ``python -m
facerecognition_tpu_torch.scripts.<name>`` and takes ``--device`` (none:
the CUDA card; ``cpu`` runs the plain path)."""
