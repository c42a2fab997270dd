"""The port's evaluations against the JAX scripts' reports on the CPU.

``ood_eval``, ``int8_agreement``, ``lbph_scale_eval`` and
``compare_all_models`` at ``tools/eval_fixture.SPEC``'s sizes against the
reports the JAX scripts wrote at the same sizes and seeds, committed in
``fixtures/evals.json`` (``make_torch_fixtures.write_evals``):
``eval_fixture.compare`` wants every count equal, or within one where
JPEG'd scenes or re-fitted aligned samples are involved, and means within
1e-3; here every count must be equal. The drivers themselves are held to
the JAX scripts in ``tests/test_torch_drivers.py``.
"""

import json

import pytest
import torch

from facerecognition_tpu_torch.tools import eval_fixture


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: six workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("part", eval_fixture.PARTS)
def test_reduced_evaluations_match_jax_fixture(part):
    """The JAX scripts' reports at the fixture's sizes, against the port's
    drivers at the same sizes and seeds."""
    ref = eval_fixture.load()
    assert ref["spec"] == json.loads(json.dumps(eval_fixture.SPEC))
    ours = eval_fixture.run_reduced("cpu", workers=2, parts=(part,))
    fails, deltas = eval_fixture.compare(ref, ours)
    assert not fails, fails
    assert deltas and all(v == 0 for k, v in deltas.items() if k.endswith("hits")), deltas
