"""zamba2-7b's loss and every gradient leaf in Sentinel's four modes at
migration intervals 1 and 2 against the reference's jitted
``value_and_grad`` (reduced, fp32, the reference's parameters carried
across): ``tests/test_torch_train.py::test_loss_and_grads_match_reference``
on the hybrid, kept in a file of its own so that the test runner's
workers share the two files' time.  Tolerances as there."""
import pytest

from test_torch_train import arch_case
from test_torch_train import test_loss_and_grads_match_reference  # noqa: F401


@pytest.fixture(scope="module", params=["zamba2-7b"])
def arch(request):
    return arch_case(request.param)
