"""The apps of the PyTorch/CUDA port: the micro-batcher, the WSGI web app,
the realtime and video pipeline and the Streamlit demo."""
