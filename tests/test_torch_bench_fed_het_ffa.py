"""Port parity of the bench's heterogeneous arm for FFA-LoRA, zero-padded
(``test_torch_bench_fed_het.check_heterogeneous``: two rounds against the
reference bench's trainer with its state carried in).  A file of its own:
the reference compiles its B-only train step once per client rank."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_bench_fed import one_thread  # noqa: E402,F401
from test_torch_bench_fed_het import check_heterogeneous  # noqa: E402


def test_heterogeneous_ffa_bench_rounds_match_reference():
    check_heterogeneous("ffa")
