"""PyTorch/CUDA port of facerecognition_tpu, slice by slice.

The serving path: ``apps.serving.MicroBatcher`` → ``inference.engine.
RecognitionEngine.fused_recognize_frames`` (resize → detector → best face or
top-K + NMS → Umeyama → warp → ArcFace or FaceNet → top-k match), the
staged engine API (``recognize``, ``recognize_batch``, ``recognize_all``,
``add_to_db``, ``match``) and the LBPH recognizer (``models.lbph``); the
enrolment and evaluation path: image files (``data.native_decode``, JPEG and
PNG), ``inference.database_builder``, ``training.train_lbph``,
``inference.evaluate`` and ``inference.explainability``; the serving apps
(``apps.web_app``, ``apps.realtime``, ``apps.streamlit_app``). Six CUDA kernels
for sm_90a (``csrc/``: ``stream_topk``, ``int8_topk``, ``warp_sample``,
``detect_post``, ``lbph_hist``, ``chi2_nn``) are built with nvcc at first
use, the image decoder (``csrc/decode.cpp``) and the JPEG encoder
(``csrc/jpeg_encode.cpp``) with the host C++ compiler.
Entry points run on the CUDA card unless given ``device="cpu"``.
"""

__version__ = "0.1.0"


def _first_vector_math_call() -> None:
    """One serial call of MKL's vector math before any parallel one.

    PyTorch's CPU ``exp``, ``log``, ``sin``, ... go through MKL's vector math
    library, which sets itself up at its first call in the process. When that
    first call is made by several intra-op threads of one operator at once
    (a tensor of more than 2,048 elements), the set-up races, and one
    thread's share can come out wrong: a whole chunk of ``torch.exp`` up to
    1,769 ulps off, in up to 1 of 30 fresh processes on a loaded 8-core
    host; every later call is exact. One call on a single element settles
    it for the whole process."""
    import torch

    torch.exp(torch.zeros(1))


_first_vector_math_call()
