"""PyTorch/CUDA port of facerecognition_tpu, slice by slice.

The first slice is the one-face fused serving path: ``apps.serving.
MicroBatcher`` → ``inference.engine.RecognitionEngine.fused_recognize_frames``
(resize → DenseDetNet → best face → Umeyama → two-pass warp → ArcFace →
streaming top-k match). The streaming top-k is a CUDA kernel for sm_90a
(``csrc/stream_topk.cu``), built with nvcc at first use. Entry points run on
the CUDA card unless given ``device="cpu"``.
"""

__version__ = "0.1.0"
