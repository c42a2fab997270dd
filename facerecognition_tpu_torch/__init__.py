"""PyTorch/CUDA port of facerecognition_tpu, slice by slice.

The serving path: ``apps.serving.MicroBatcher`` → ``inference.engine.
RecognitionEngine.fused_recognize_frames`` (resize → detector → best face or
top-K + NMS → Umeyama → warp → ArcFace → top-k match), and the staged
engine API (``recognize``, ``recognize_batch``, ``recognize_all``,
``add_to_db``, ``match``). Four CUDA kernels for sm_90a (``csrc/``:
``stream_topk``, ``int8_topk``, ``warp_sample``, ``detect_post``) are built
with nvcc at first use. Entry points run on the CUDA card unless given
``device="cpu"``.
"""

__version__ = "0.1.0"
