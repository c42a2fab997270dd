"""Training entry points of the port: the ArcFace, FaceNet and LBPH trainers."""
