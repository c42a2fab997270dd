"""Export a FaceNet training checkpoint to the serving msgpack format.

Counterpart of ``scripts/export_facenet.py``: restores the port's training
checkpoint (``training/checkpoint.CheckpointManager``, ``ckpt_{tag}/``,
written by ``training/train_facenet``) and writes its model's weights and
batch statistics as flax ``{'params', 'batch_stats'}`` (``convert.
state_dict_to_flax``) through ``utils/serialization.save_variables``, the
file both packages' ``load_facenet_model`` and
``RecognitionEngine(model_type='facenet')`` read.

    python -m facerecognition_tpu_torch.scripts.export_facenet --ckpt-dir checkpoints/facenet \
        --tag best --out facenet.msgpack
"""

from __future__ import annotations

from facerecognition_tpu_torch.device import resolve_device


def export_facenet(ckpt_dir: str, tag: str, out: str) -> dict:
    """Write the serving file; returns the checkpoint's metadata."""
    from facerecognition_tpu_torch.convert import state_dict_to_flax
    from facerecognition_tpu_torch.training.checkpoint import CheckpointManager
    from facerecognition_tpu_torch.utils.serialization import save_variables

    tree, meta = CheckpointManager(ckpt_dir).restore(tag, map_location="cpu")
    variables = state_dict_to_flax(tree["model"])
    save_variables(out, {"params": variables["params"], "batch_stats": variables["batch_stats"]})
    return meta or {}


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="FaceNet training checkpoint -> serving msgpack")
    ap.add_argument("--ckpt-dir", default="checkpoints/facenet")
    ap.add_argument("--tag", default="best")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    meta = export_facenet(args.ckpt_dir, args.tag, args.out)
    hist = meta.get("history") or []
    last = hist[-1] if hist else {}
    print(f"exported {args.ckpt_dir}/ckpt_{args.tag} -> {args.out} "
          f"(epoch {last.get('epoch')}, val_loss {last.get('val_loss')}, "
          f"ver_acc {last.get('verification_accuracy')})")
    return meta


if __name__ == "__main__":
    main()
