"""Streamlit demo: single-upload recognition on the port.

Counterpart of ``facerecognition_tpu/apps/streamlit_app.py``. Run with
``streamlit run facerecognition_tpu_torch/apps/streamlit_app.py``;
``streamlit`` is imported inside ``run()``, so environments without it get
a clear message. The upload is read by ``utils/imageio.load_image`` (the
port's decoder, JPEG and PNG); the engine runs on ``FRT_DEVICE`` (default:
the CUDA card). Environment: ``ARCFACE_CKPT``, ``FACE_DB``,
``FACE_DETECTOR=off``.
"""

from __future__ import annotations

import os


def run():
    try:
        import streamlit as st
    except ImportError as exc:  # pragma: no cover
        raise SystemExit(
            "streamlit is not installed — use the WSGI app instead: "
            "python -m facerecognition_tpu_torch.apps.web_app"
        ) from exc

    from facerecognition_tpu_torch.inference.engine import Gallery, RecognitionEngine
    from facerecognition_tpu_torch.utils.imageio import load_image

    st.title("Face recognition (PyTorch/CUDA)")
    device = os.environ.get("FRT_DEVICE") or None

    @st.cache_resource
    def get_engine():
        # Detect + align by default: an upload is recognized by its largest
        # face, warped to the template, not by a whole-image embedding.
        # FACE_DETECTOR=off opts out.
        detector = None
        if os.environ.get("FACE_DETECTOR", "on").lower() not in ("off", "0"):
            from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector

            detector = FaceDetector(device=device)
        engine = RecognitionEngine(
            model_type="arcface",
            checkpoint_path=os.environ.get("ARCFACE_CKPT"),
            threshold=0.5,
            detector=detector,
            device=device,
        )
        gallery_path = os.environ.get("FACE_DB", "databases/arcface/face_db.npy")
        if os.path.exists(gallery_path):
            engine.gallery = Gallery.load(gallery_path, device=device)
        return engine

    engine = get_engine()
    st.sidebar.write(f"Gallery identities: {len(engine.gallery)}")
    threshold = st.sidebar.slider("Threshold", 0.0, 1.0, 0.5, 0.05)
    engine.set_threshold(threshold)

    upload = st.file_uploader("Upload a face image", type=["jpg", "jpeg", "png"])
    if upload is not None:
        image = load_image(upload.read())
        st.image(image, caption="Input", width=300)
        result = engine.recognize(image)
        if result["status"] != "success":
            st.error(result.get("message", "recognition failed"))
        else:
            st.subheader(result["identity"])
            st.write(f"confidence: {result['confidence']:.4f}")
            if result["top_k"]:
                st.table([{"identity": n, "score": f"{s:.4f}"} for n, s in result["top_k"]])


def _in_streamlit_runtime() -> bool:
    try:
        from streamlit.runtime import exists

        return exists()
    except ImportError:
        return False


if __name__ == "__main__" or _in_streamlit_runtime():
    run()
