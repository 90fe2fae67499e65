"""Port parity of the bench's heterogeneous arm for FLoRA and FlexLoRA
(``test_torch_bench_fed_het.check_heterogeneous``: two rounds against the
reference bench's trainer with its state carried in)."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_bench_fed import one_thread  # noqa: E402,F401
from test_torch_bench_fed_het import check_heterogeneous  # noqa: E402


@pytest.mark.parametrize("method", ["flora", "flexlora"])
def test_heterogeneous_bench_rounds_match_reference(method):
    check_heterogeneous(method)
