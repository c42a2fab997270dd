"""Load-test the micro-batching serving API end to end over HTTP.

Counterpart of ``examples/serving_bench.py``. Starts the port's threaded
WSGI app (``apps/web_app``: ``EngineRegistry``, ``create_app``, served by
``wsgiref`` with a thread per request) in this process, with the shipped
detector and ArcFace and a ``--gallery``-row synthetic gallery, fires
``--clients`` concurrent clients at ``POST /recognize`` (one rendered face
scene, JPEG-encoded once; ``--images-per-request`` > 1 posts a multipart
body of that many scenes) and reports throughput, latency percentiles and
the batcher's coalescing counters over the timed run, with the JAX script's
keys. A warm-up burst of one request per client runs first (it builds the
kernels and plans each batch size); a ``--max-queue`` small enough sheds
requests with 429, counted in ``shed_429``.

    python -m facerecognition_tpu_torch.examples.serving_bench \\
        [--clients 32] [--requests 256] [--frame 256] [--port 8123] [--device cpu]

``--port 0`` takes a free port.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from facerecognition_tpu_torch.device import DeviceLike, resolve_device

BOUNDARY = "servingbenchboundary"

#: The keys of the report line (the JAX script's).
REPORT_KEYS = ("requests", "images_per_request", "failed", "shed_429", "clients", "throughput_rps",
               "throughput_imgs_s", "p50_ms", "p99_ms", "mean_batch", "batches", "device_duty_cycle",
               "frame", "server")


def request_body(jpegs: list[bytes]) -> tuple[bytes, dict]:
    """One JPEG as ``image/jpeg``, several as a multipart body."""
    if len(jpegs) == 1:
        return jpegs[0], {"Content-Type": "image/jpeg"}
    parts = [
        (f"--{BOUNDARY}\r\nContent-Disposition: form-data; "
         f'name="file"; filename="f{i}.jpg"\r\nContent-Type: image/jpeg\r\n\r\n').encode() + j + b"\r\n"
        for i, j in enumerate(jpegs)
    ]
    return b"".join(parts) + f"--{BOUNDARY}--\r\n".encode(), {
        "Content-Type": f"multipart/form-data; boundary={BOUNDARY}"}


def _get_json(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def run(clients: int = 32, requests: int = 256, frame: int = 256, port: int = 8123,
        gallery: int = 1000, max_delay_ms: float = 5.0, max_queue: int = 1024,
        images_per_request: int = 1, device: DeviceLike = None, log=print) -> dict:
    """The benchmark: ``{"report": the JAX script's JSON, "jpegs": the
    uploaded images, "answers": each warm-up response, "engine": the
    served engine}``. The server is shut down before it returns."""
    from facerecognition_tpu_torch.apps.web_app import EngineRegistry, create_app, make_threaded_server
    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector
    from facerecognition_tpu_torch.training.synthetic_faces import scene_batch
    from facerecognition_tpu_torch.utils.imageio import encode_jpeg

    device = resolve_device(device)
    registry = EngineRegistry(detector=FaceDetector(confidence_threshold=0.3, device=device),
                              device=device)
    engine = registry.get("arcface")
    if engine is None:
        raise FileNotFoundError("no serving ArcFace checkpoint found in assets/")
    rng = np.random.default_rng(0)
    gal = rng.normal(size=(gallery, 512)).astype(np.float32)
    engine.gallery.add_many([f"id_{i}" for i in range(gallery)], gal)
    app = create_app(registry, batcher_opts={"frame_size": (frame, frame),
                                             "max_delay_ms": max_delay_ms, "max_queue": max_queue})
    server = make_threaded_server("127.0.0.1", port, app)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base_url = f"http://127.0.0.1:{server.server_address[1]}"
    url = base_url + "/recognize"
    try:
        n_per = max(1, images_per_request)
        frames = scene_batch(rng, n_per, frame, max_faces=1, p_face=1.0)[0]
        jpegs = [encode_jpeg(frames[i].astype(np.uint8), 90) for i in range(n_per)]
        payload, headers = request_body(jpegs)

        def post():
            req = urllib.request.Request(url, data=payload, headers=headers)
            try:
                with urllib.request.urlopen(req, timeout=1800) as r:
                    return json.loads(r.read())
            except (ConnectionResetError, ConnectionRefusedError):
                # one retry on a transport reset (a backlog burst); HTTP
                # errors (429/5xx) propagate
                with urllib.request.urlopen(req, timeout=1800) as r:
                    return json.loads(r.read())

        log("warmup burst (builds the kernels, plans the batch sizes)...")
        warm = [None] * clients

        def warm_client(i):
            # a small --max-queue sheds (429) and a first build can outlive
            # the batcher's timeout (503): back off until the request lands
            while True:
                try:
                    warm[i] = post()
                    return
                except urllib.error.HTTPError as e:
                    if e.code not in (429, 503):
                        raise
                    time.sleep(0.5)

        threads = [threading.Thread(target=warm_client, args=(i,)) for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if any(r is None for r in warm):
            raise RuntimeError("warmup request failed")
        first = warm[0]["results"][0] if "results" in warm[0] else warm[0]
        log(f"warmup ok: identity={first['identity']!r}")
        base = _get_json(base_url + "/stats")["models"]["arcface"]["batching"]

        latencies, failures, shed = [], [0], [0]
        lock = threading.Lock()
        left = [requests]
        last_stats = [base]

        def client():
            while True:
                with lock:
                    if left[0] <= 0:
                        return
                    left[0] -= 1
                t0 = time.perf_counter()
                was_shed = False
                try:
                    res = post()
                    rs = res["results"] if "results" in res else [res]
                    ok = all(r.get("status") == "success" for r in rs)
                except urllib.error.HTTPError as e:
                    ok, was_shed = False, e.code == 429
                except Exception:
                    ok = False
                dt = time.perf_counter() - t0
                with lock:
                    if ok:
                        latencies.append(dt)
                        if res["batching"]["requests"] > last_stats[0]["requests"]:
                            last_stats[0] = res["batching"]
                    elif was_shed:
                        shed[0] += 1
                    else:
                        failures[0] += 1

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client) for _ in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        server_stats = _get_json(base_url + "/stats")["models"].get("arcface", {}).get("batching")
    finally:
        server.shutdown()
        server.server_close()
    if not latencies:
        raise RuntimeError(f"all {requests} requests failed")
    end = server_stats if server_stats else last_stats[0]
    d_req = end["requests"] - base["requests"]
    d_bat = end["batches"] - base["batches"]
    # the share of the timed wall that the dispatcher spent inside fused
    # calls: below 1 the host (decode, parse, respond) bounds the rate
    duty = round((end["dispatch_s"] - base["dispatch_s"]) / wall, 3)
    lat = np.sort(np.asarray(latencies)) * 1000
    report = {
        "requests": requests,
        "images_per_request": n_per,
        "failed": failures[0],
        "shed_429": shed[0],
        "clients": clients,
        "throughput_rps": round(len(latencies) / wall, 1),
        "throughput_imgs_s": round(len(latencies) * n_per / wall, 1),
        "p50_ms": round(float(lat[len(lat) // 2]), 1),
        "p99_ms": round(float(lat[min(int(len(lat) * 0.99), len(lat) - 1)]), 1),
        "mean_batch": round(d_req / d_bat, 2) if d_bat else None,
        "batches": d_bat,
        "device_duty_cycle": duty,
        "frame": frame,
        "server": server_stats,
    }
    return {"report": report, "jpegs": jpegs, "answers": warm, "engine": engine}


def main(argv=None) -> dict:
    import argparse

    ap = argparse.ArgumentParser(description="HTTP load on /recognize through the micro-batcher")
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--frame", type=int, default=256)
    ap.add_argument("--port", type=int, default=8123, help="0 takes a free port")
    ap.add_argument("--gallery", type=int, default=1000)
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    ap.add_argument("--max-queue", type=int, default=1024,
                    help="MicroBatcher pending cap; small values provoke 429 load shedding")
    ap.add_argument("--images-per-request", type=int, default=1,
                    help=">1 posts a multipart body with N images per request; throughput_rps "
                    "counts bodies/s, throughput_imgs_s images/s")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = run(args.clients, args.requests, args.frame, args.port, args.gallery, args.max_delay_ms,
              args.max_queue, args.images_per_request, resolve_device(args.device))
    print(json.dumps(out["report"]), flush=True)
    return out["report"]


if __name__ == "__main__":
    main()
