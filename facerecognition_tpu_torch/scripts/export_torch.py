"""Export a serving checkpoint (.msgpack) to a reference-loadable .pth.

Counterpart of ``scripts/export_torch.py``: the ArcFace or FaceNet
msgpack file as the reference stack's state dict (``convert.
export_arcface_state_dict`` / ``export_facenet_state_dict``: OIHW convs,
(out, in) linears, ``running_*`` statistics), saved under
``model_state_dict`` (``convert.save_torch_checkpoint``). The port's
``load_arcface_model`` / ``load_facenet_model`` read the file back
(``convert.arcface_state_dict`` / ``facenet_state_dict``) to the same
weights. A slim ArcFace (``stage_sizes`` other than (3, 4, 6, 3)) exports
too; torchvision's resnet50 cannot load it, the port's loader can.

    python -m facerecognition_tpu_torch.scripts.export_torch --model arcface \
        --ckpt assets/arcface_synthid9k_ultraslim_512.msgpack --out arcface.pth
"""

from __future__ import annotations

from facerecognition_tpu_torch.device import resolve_device


def export_torch(model: str, ckpt: str, out: str, prefix: str = "model.") -> dict:
    """Write ``out``; returns ``{"tensors", "stage_sizes"}`` (the latter
    for ArcFace)."""
    import numpy as np

    from facerecognition_tpu_torch.convert import (
        export_arcface_state_dict,
        export_facenet_state_dict,
        save_torch_checkpoint,
    )
    from facerecognition_tpu_torch.utils.serialization import load_variables

    variables = load_variables(ckpt)
    stages = None
    if model == "arcface":
        raw = variables.pop("stage_sizes", None)
        stages = (3, 4, 6, 3) if raw is None else tuple(int(v) for v in np.asarray(raw))
        sd = export_arcface_state_dict(variables)
    elif model == "facenet":
        sd = export_facenet_state_dict(variables, prefix=prefix)
    else:
        raise ValueError(f"unknown model {model!r}")
    save_torch_checkpoint(out, sd)
    return {"tensors": len(sd), "stage_sizes": stages}


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Serving msgpack -> reference-layout .pth")
    ap.add_argument("--model", choices=["arcface", "facenet"], required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--prefix", default="model.",
                    help="facenet backbone key prefix ('' for bare InceptionResnetV1)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    info = export_torch(args.model, args.ckpt, args.out, args.prefix)
    if info["stage_sizes"] not in (None, (3, 4, 6, 3)):
        print(f"note: backbone depth {list(info['stage_sizes'])}: torchvision's resnet50 cannot "
              "load this file; the port's load_arcface_model can")
    print(f"exported {args.ckpt} -> {args.out} ({info['tensors']} tensors)")
    return info


if __name__ == "__main__":
    main()
