"""Port parity of the paper-evaluation bench's federated runs
(``repro_torch.benchmarks.common.bench_trainer`` / ``bench_fed``) against
the reference bench's trainer (``benchmarks/common.py``'s settings), on the
CPU.

The reference trainer is built as the reference ``bench_fed`` builds it;
the port's comes from ``bench_trainer(..., device="cpu")`` and is handed
the reference's ``params`` and ``A_init_full`` (``repro_torch.convert``)
before its first round; then two rounds run on each.  The data, the client
sample and the batch schedule are numpy in both packages.  Kept ranks,
``download_rank``, ``global_rank_total``, parameter counts and wire bytes
are compared exactly, ``eval_loss`` within 1e-4 and ``eval_acc`` within
one eval token's share.  This file holds the bench's settings and
FLoRIST's homogeneous runs at τ 0.9, 0.7 and ``"auto"``; the other
methods' homogeneous runs are in ``test_torch_bench_fed_hom.py`` and the
heterogeneous arm in ``test_torch_bench_fed_het*.py`` (split so that no
file takes much over 40 s on one thread: the reference compiles its train
step once per client rank).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from benchmarks import common as jcommon  # noqa: E402
from repro.common.config import FedConfig as JFedConfig  # noqa: E402
from repro.core.federated import FederatedTrainer as JTrainer  # noqa: E402
from repro_torch.benchmarks import common as tcommon  # noqa: E402
from repro_torch.convert import adapters_from_numpy, params_from_numpy  # noqa: E402

ROUNDS = 2
EXACT = ("upload_params", "download_params", "upload_bytes", "download_bytes",
         "download_rank", "global_rank_total")


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: the suite runs files on parallel workers,
    and a full torch thread pool on each of them oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_config(method, heterogeneous=False, tau=0.9):
    """The ``FedConfig`` the reference ``bench_fed`` builds
    (``benchmarks/common.py``)."""
    return JFedConfig(
        num_clients=20, clients_per_round=5, method=method, tau=tau,
        homogeneous_rank=8, heterogeneous=heterogeneous,
        rank_distribution=((4, 8), (8, 4), (16, 4), (32, 2), (64, 2)),
        zero_padding=heterogeneous and method in ("fedit", "ffa"), seed=0)


def bench_pair(method, heterogeneous=False, tau=0.9):
    """Two rounds of the reference bench's trainer and of the port's
    ``bench_trainer`` with the reference's state carried in; asserts the
    records and ranks agree round by round.  Returns the port's trainer."""
    jt = JTrainer(jcommon.BENCH_MODEL,
                  reference_config(method, heterogeneous, tau),
                  jcommon.BENCH_LORA, jcommon.BENCH_OPT, batch_size=8,
                  local_steps=4, seq_len=32)
    tt = tcommon.bench_trainer(method, heterogeneous=heterogeneous, tau=tau,
                               device="cpu")
    tt.params = params_from_numpy(jax.device_get(jt.params), "cpu")
    tt.A_init_full = adapters_from_numpy(jax.device_get(jt.A_init_full), "cpu")
    one_token = 1.0 / float(tt.eval_batch["loss_mask"].sum())
    for rnd in range(ROUNDS):
        jrec, rec = jt.run_round(rnd), tt.run_round(rnd)
        assert tt.global_state.ranks == {
            p: [int(v) for v in r] for p, r in jt.global_state.ranks.items()}
        for k in EXACT:
            assert getattr(rec, k) == getattr(jrec, k), (rnd, k)
        assert rec.upload_bytes == 4 * rec.upload_params     # the fp32 wire
        assert np.isfinite(rec.eval_loss)
        assert rec.eval_loss == pytest.approx(jrec.eval_loss, abs=1e-4)
        assert abs(rec.eval_acc - jrec.eval_acc) <= one_token + 1e-9
    return tt


def test_bench_settings_are_the_reference_s():
    for name in ("BENCH_MODEL", "BENCH_LORA", "BENCH_OPT"):
        ours = dataclasses.asdict(getattr(tcommon, name))
        ref = dataclasses.asdict(getattr(jcommon, name))
        assert {k: ours[k] for k in ref} == ref, name
    for method in ("florist", "fedit", "ffa", "flora", "flexlora"):
        for heter in (False, True):
            ours = dataclasses.asdict(tcommon.bench_config(
                method, heterogeneous=heter))
            ref = dataclasses.asdict(reference_config(method, heter))
            assert ours == ref, (method, heter)


@pytest.mark.parametrize("tau", [0.9, 0.7, "auto"])
def test_homogeneous_florist_bench_rounds_match_reference(tau):
    tt = bench_pair("florist", False, tau)
    assert set(tt.client_ranks) == {8}
    assert all(1 <= p <= 40 for ps in tt.global_state.ranks.values()
               for p in ps)
