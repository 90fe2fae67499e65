"""Port parity of the bench's heterogeneous arm for FLoRIST and FedIT: the
paper's rank mix ``((4, 8), (8, 4), (16, 4), (32, 2), (64, 2))`` over 20
clients, 5 a round (FedIT zero-padded), two rounds each against the
reference bench's trainer with its state carried in
(``test_torch_bench_fed.bench_pair``: ranks, counts and bytes exact,
``eval_loss`` within 1e-4, ``eval_acc`` within one eval token's share).
FLoRA and FlexLoRA are in ``test_torch_bench_fed_het_flora.py``, FFA-LoRA
in ``test_torch_bench_fed_het_ffa.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_bench_fed import bench_pair, one_thread  # noqa: E402,F401


def check_heterogeneous(method):
    """:func:`bench_pair` in the heterogeneous arm, then the ranks each
    method's broadcast must have."""
    tt = bench_pair(method, True, 0.9)
    ranks = tt.aggregator.client_ranks          # the last round's sample
    assert set(ranks) <= {4, 8, 16, 32, 64} and len(ranks) == 5
    want = {"fedit": lambda p: p == max(ranks),      # zero-padded
            "ffa": lambda p: p == max(ranks),
            "flora": lambda p: p == sum(ranks),
            "flexlora": lambda p: p <= 64,
            "florist": lambda p: 1 <= p <= sum(ranks)}[method]
    assert all(want(p) for ps in tt.global_state.ranks.values() for p in ps)


@pytest.mark.parametrize("method", ["florist", "fedit"])
def test_heterogeneous_bench_rounds_match_reference(method):
    check_heterogeneous(method)
