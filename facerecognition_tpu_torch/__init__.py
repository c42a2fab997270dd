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
