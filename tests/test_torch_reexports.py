"""The port's package ``__all__`` lists against the JAX package's, and the
imports that a re-export hides.

Every name a JAX subpackage lists in ``__all__`` is listed by the port's
subpackage of the same name and resolves there (``ABSENT`` lists none:
``training.ArcFaceTrainState`` is the port's flax-layout train state).
JAX's ``ops`` binds functions named like its modules (``umeyama``); the
port's does too, so ``from facerecognition_tpu_torch.ops import umeyama``
gives the function: no module of the port, its tools or its tests may
import a module that way.
"""

import ast
import importlib
import os
import types

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("ops", "models", "inference", "training", "data", "utils", "preprocessing", "parallel")
#: Names of the JAX package's ``__all__`` the port leaves out, with the reason in ROADMAP.
ABSENT: dict = {}


@pytest.mark.parametrize("package", PACKAGES)
def test_all_lists_name_what_jax_lists(package):
    jax_pkg = importlib.import_module(f"facerecognition_tpu.{package}")
    port = importlib.import_module(f"facerecognition_tpu_torch.{package}")
    want = set(jax_pkg.__all__) - ABSENT.get(package, set())
    assert set(port.__all__) == want
    for name in port.__all__:
        value = getattr(port, name)
        assert not isinstance(value, types.ModuleType), name
    assert not ABSENT.get(package, set()) & set(port.__all__)


def test_ops_binds_the_umeyama_function():
    ops = importlib.import_module("facerecognition_tpu_torch.ops")
    module = importlib.import_module("facerecognition_tpu_torch.ops.umeyama")
    assert ops.umeyama is module.umeyama and callable(ops.umeyama)


def _sources():
    roots = [os.path.join(REPO, "facerecognition_tpu_torch"), os.path.join(REPO, "tests")]
    for root in roots:
        for dirpath, _, files in os.walk(root):
            for name in files:
                if not name.endswith(".py"):
                    continue
                if root.endswith("tests") and not name.startswith("test_torch_"):
                    continue
                yield os.path.join(dirpath, name)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "make_torch_fixtures.py")


def test_no_import_of_a_hidden_module():
    """``from facerecognition_tpu_torch.<pkg> import <m>`` and ``import
    facerecognition_tpu_torch.<pkg>.<m> as x`` take the package's attribute:
    where the package binds a non-module under a submodule's name, that is
    not the module. Such imports go through ``importlib.import_module``."""
    hidden = {}
    for package in PACKAGES:
        pkg = importlib.import_module(f"facerecognition_tpu_torch.{package}")
        folder = os.path.dirname(pkg.__file__)
        for name in getattr(pkg, "__all__", []):
            if os.path.exists(os.path.join(folder, f"{name}.py")):
                hidden[f"facerecognition_tpu_torch.{package}"] = hidden.get(
                    f"facerecognition_tpu_torch.{package}", set()) | {name}
    assert hidden == {"facerecognition_tpu_torch.ops": {"umeyama"}}
    bad = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module in hidden:
                bad += [f"{path}:{node.lineno}" for a in node.names if a.name in hidden[node.module]]
            elif isinstance(node, ast.Import):
                for a in node.names:
                    parent, _, leaf = a.name.rpartition(".")
                    if a.asname and leaf in hidden.get(parent, ()):
                        bad.append(f"{path}:{node.lineno}")
    assert not bad, bad
