"""Port parity of the bench's homogeneous arm (rank 8, 20 clients, 5 a
round) for FedIT, FFA-LoRA, FLoRA and FlexLoRA: two rounds each against the
reference bench's trainer with its state carried in
(``test_torch_bench_fed.bench_pair``: ranks, counts and bytes exact,
``eval_loss`` within 1e-4, ``eval_acc`` within one eval token's share).
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_bench_fed import bench_pair, one_thread  # noqa: E402,F401

# global rank a layer of each method's broadcast at rank 8 and 5 clients
RANK = {"fedit": 8, "ffa": 8, "flora": 40, "flexlora": 8}


@pytest.mark.parametrize("method", sorted(RANK))
def test_homogeneous_bench_rounds_match_reference(method):
    tt = bench_pair(method, False, 0.9)
    assert all(p == RANK[method] for ps in tt.global_state.ranks.values()
               for p in ps)
