"""The rank side of the data-parallel tests (``test_torch_parallel.py``,
``test_torch_parallel_train.py``): what each spawned gloo rank runs. It
imports neither JAX nor the JAX package, so a rank starts in seconds; the
JAX side stays in the test files.
"""

import functools
import os

import torch

from facerecognition_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from facerecognition_tpu_torch.models.arcface import ArcFaceModel
from facerecognition_tpu_torch.models.layers import BatchNorm1d, BatchNorm2d, dropout
from facerecognition_tpu_torch.parallel import ShardedGallery, create_mesh, resolve_data_mesh
from facerecognition_tpu_torch.parallel.collectives import BatchShard, batch_shard
from facerecognition_tpu_torch.parallel.mesh import MeshDevice
from facerecognition_tpu_torch.training import steps, train_arcface
from facerecognition_tpu_torch.training.optim import OptaxChain
from facerecognition_tpu_torch.training.schedules import build_schedule

B, S, C, EMB, SPE = 8, 32, 10, 32, 3
P, K, FS = 4, 2, 24
MIXUP = 0.4
CPU = torch.device("cpu")


def arc_config() -> dict:
    return {
        "model": {"embedding_size": EMB, "scale": 64.0, "margin": 0.3, "easy_margin": False,
                  "dropout": 0.0, "freeze_ratio": 0.0},
        "train": {"num_epochs": 4, "steps_per_epoch": SPE, "optimizer": "sgd", "lr": 0.05, "momentum": 0.9,
                  "weight_decay": 5e-4, "schedule": "cosine", "warmup_epochs": 1, "step_size_epochs": 10,
                  "gamma": 0.1, "grad_clip": 0.5, "label_smoothing": 0.1, "mixup_alpha": MIXUP,
                  "margin_warmup_epochs": 0, "margin_start": 0.0},
    }


class TinyEmbed(torch.nn.Module):
    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = p
        self.conv = torch.nn.Conv2d(3, 8, 3, stride=2, bias=False)
        self.bn = BatchNorm2d(8, eps=1e-3)
        self.last_linear = torch.nn.Linear(8, 16, bias=False)
        self.last_bn = BatchNorm1d(16, eps=1e-3)

    def forward(self, x, generator=None):
        x = torch.relu(self.bn(self.conv(x.permute(0, 3, 1, 2))))
        x = dropout(x.mean(dim=(2, 3)), self.p, self.training, generator)
        x = self.last_bn(self.last_linear(x))
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-12)


# -- the port's steps, in a rank or in one process ------------------------------------


def _arc_port(variables, dropout_p=0.0, dtype="float32"):
    """``dtype`` "float64": the float32 model run in float64."""
    port = ArcFaceModel(EMB, (1, 1, 1, 1), num_classes=C, margin=0.3, easy_margin=False, dropout=dropout_p,
                        dtype="float32" if dtype == "float64" else dtype)
    port.load_state_dict(flax_to_state_dict(variables, include_head=True), strict=True)
    if dtype == "float64":
        port = port.double()
    return steps.TrainState(port, train_arcface.build_tx(arc_config(), SPE, port))


def _facenet_port(variables):
    port = TinyEmbed()
    port.load_state_dict(flax_to_state_dict(variables), strict=True)
    chain = OptaxChain(dict(port.named_parameters()), "adam",
                       build_schedule(1e-2, "step", 100, step_size=10, gamma=0.5))
    return steps.TrainState(port, chain)


def _result(state, metrics):
    return {"metrics": [{k: float(v) for k, v in m.items()} for m in metrics],
            "variables": state_dict_to_flax(state.model.state_dict())}


def run_port(shard, data):
    """The port's steps on ``data`` (the global batches and JAX's draws);
    ``shard`` None: one process. Returns each case's metrics and variables."""
    take = (lambda a: a) if shard is None else (lambda a: a[shard.start:shard.start + shard.rows])
    out = {}
    state = _arc_port(data["arc_vars"])
    step = steps.make_arcface_train_step(0.1, MIXUP)
    metrics = []
    for x, labels, lam, perm in data["arc_batches"]:
        metrics.append(step(state, torch.from_numpy(take(x)), torch.from_numpy(take(labels)).long(),
                            mix=(lam, torch.from_numpy(perm)), shard=shard))
    out["arcface"] = _result(state, metrics)
    for mining in ("semi_hard", "batch_hard"):
        state = _facenet_port(data["facenet_vars"])
        step = steps.make_facenet_train_step(0.5, mining)
        metrics = [step(state, torch.from_numpy(take(x)), torch.from_numpy(take(data["pk_labels"])).long(),
                        shard=shard)
                   for x in data["facenet_batches"]]
        out[mining] = _result(state, metrics)
    # the generator's own draws: augmentation-free ArcFace with dropout and
    # mixup, FaceNet with remat and dropout
    gen = torch.Generator().manual_seed(5)
    state = _arc_port(data["arc_vars"], dropout_p=0.5)
    step = steps.make_arcface_train_step(0.1, MIXUP)
    metrics = [step(state, torch.from_numpy(take(x)), torch.from_numpy(take(labels)).long(), gen, shard=shard)
               for x, labels, _, _ in data["arc_batches"]]
    out["arcface_draws"] = _result(state, metrics)
    gen = torch.Generator().manual_seed(6)
    state = _facenet_port(data["facenet_vars"])
    state.model.p = 0.3
    step = steps.make_facenet_train_step(0.5, "random", remat=True)
    metrics = [step(state, torch.from_numpy(take(x)), torch.from_numpy(take(data["pk_labels"])).long(), gen,
                    shard=shard)
               for x in data["facenet_batches"]]
    out["facenet_draws"] = _result(state, metrics)
    return out


def _rank_run(rank, world, data):
    return run_port(BatchShard(rank, world, B), data)


def run_port_dtype(shard, data, dtype="bfloat16"):
    """The ArcFace steps in ``dtype`` on ``data["arc_batches"]`` with their
    mixup draws; ``shard`` None: one process."""
    take = (lambda a: a) if shard is None else (lambda a: a[shard.start:shard.start + shard.rows])
    state = _arc_port(data["arc_vars"], dtype=dtype)
    wide = torch.float64 if dtype == "float64" else torch.float32
    step = steps.make_arcface_train_step(0.1, MIXUP)
    metrics = [step(state, torch.from_numpy(take(x)).to(wide), torch.from_numpy(take(labels)).long(),
                    mix=(lam, torch.from_numpy(perm)), shard=shard)
               for x, labels, lam, perm in data["arc_batches"]]
    return _result(state, metrics)


def _rank_run_dtype(rank, world, data, dtype):
    return run_port_dtype(BatchShard(rank, world, B), data, dtype)


def two_rank_search(rank, g, q, quantize):
    """One rank of a 2-rank group holding 2 of the 4 shards."""
    devices = [MeshDevice(i, CPU, i // 2) for i in range(4)]
    sg = ShardedGallery(create_mesh(devices, gallery=4), dim=g.shape[1], quantize=quantize)
    sg.set_all([str(i) for i in range(len(g))], g)
    assert len(sg._shards) == 2  # only this rank's shards
    return [sg.topk(q, k) for k in (1, 6)] + [data_mesh_in_a_group()]


def data_mesh_in_a_group() -> dict:
    """``resolve_data_mesh`` in this rank's group: its shape and this rank's
    own entry; what a batch the world size does not divide raises."""
    mesh = resolve_data_mesh("auto", 12, CPU)
    out = {"shape": mesh.shape, "local": [(pos, d.process_index) for pos, d in mesh.local("data")],
           "two": resolve_data_mesh(2, 12, CPU).shape}
    for bad in ((3, 12), ("auto", 13)):
        try:
            resolve_data_mesh(*bad, CPU)
        except ValueError as exc:
            out[str(bad)] = str(exc)
    return out


def _trainer_config(faces, ckpt, num_devices):
    return {
        "model": {"embedding_size": 16, "dropout": 0.5},
        "data": {"data_dir": faces, "image_size": 32, "val_frac": 0.25, "augmentation": "normal",
                 "num_workers": 1, "min_images": 1},
        "train": {"batch_size": 8, "num_epochs": 1, "steps_per_epoch": 2, "lr": 0.001, "warmup_epochs": 0,
                  "mixup_alpha": 0.4, "early_stopping_patience": 50, "num_devices": num_devices},
        "eval": {"num_pairs": 20, "batch_size": 16},
        "checkpoint": {"dir": ckpt, "keep_last_n": 1, "save_every_epochs": 1},
    }


def run_trainer(rank, faces, ckpt, num_devices):
    """An epoch, a save, a resume, another epoch, on a (1,1,1,1) ResNet."""
    from facerecognition_tpu_torch.training import train_arcface as ta

    ta.ArcFaceModel = functools.partial(ArcFaceModel, stage_sizes=(1, 1, 1, 1))
    trainer = ta.ArcFaceTrainer(_trainer_config(faces, ckpt, num_devices), device="cpu")
    first = trainer.train()
    again = ta.ArcFaceTrainer(_trainer_config(faces, ckpt, num_devices), device="cpu")
    again.resume("last", extend_epochs=1)
    second = again.train()
    files = sorted(os.listdir(again.ckpt.directory))
    return {"history": [first, second], "files": files, "shard": again.shard,
            "variables": state_dict_to_flax(again.model.state_dict())}


def run_facenet_trainer(rank, faces, ckpt, num_devices):
    """A FaceNet epoch of one step (InceptionResnetV1 at 80², P 2 x K 2,
    streaming)."""
    from facerecognition_tpu_torch.training.train_facenet import FaceNetTrainer

    cfg = {
        "data": {"data_dir": faces, "image_size": 80, "val_frac": 0.25, "augmentation": "light",
                 "num_workers": 1, "min_images": 1, "resident": False},
        "train": {"p_identities": 2, "k_images": 2, "num_epochs": 1, "steps_per_epoch": 1, "lr": 1e-4,
                  "num_devices": num_devices},
        "eval": {"num_pairs": 20, "batch_size": 8},
        "checkpoint": {"dir": ckpt, "keep_last_n": 1},
    }
    trainer = FaceNetTrainer(cfg, device="cpu")
    history = trainer.train()
    trainer.config["data"]["resident"] = "auto"
    return {"history": history, "shard": trainer.shard, "resident": trainer._ensure_resident(),
            "files": sorted(os.listdir(trainer.ckpt.directory)),
            "variables": state_dict_to_flax(trainer.model.state_dict())}


def test_batch_shard_takes_equal_rows():
    """A rank's rows of the global batch; no group: no shard."""
    shard = BatchShard(1, 4, 12)
    assert (shard.rows, shard.start) == (3, 3)
    assert shard.take(torch.arange(12)).tolist() == [3, 4, 5]
    assert batch_shard(12) is None
