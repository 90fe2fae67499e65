"""``chip_smoke.replay_launches``: the port's launches a decode window's
graph replays ran, read from a profiler trace.  ``chip_smoke.py`` holds the
launch counters' rise (added by bookkeeping at each replay) to it.  A trace
can lose records but never adds any, and every replay of a graph runs the
same kernels, so each call is held to the fullest traced replay: a lost
replay or a replay's lost kernels do not read as a bookkeeping fault, while
a wrong count a replay still does.  Plain Python on correlation ids,
checked here on the CPU; ``chip_smoke.py`` runs it on the card's traces."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

STEP, BURST = (1, 1), (1, 8)
MLA = {"mla_ring_decode": 6, "bgmv": 12}          # deepseek_smoke, a step
LLAMA = {"ring_decode": 16, "bgmv": 64}            # Llama-3.2-1B, a step


def trace(replays, first_id=100):
    """Launch ids and (correlation id, wrapper) kernels of replays holding
    the given launches each, plus port kernels launched outside a graph."""
    launches = [first_id + i for i in range(len(replays))]
    kernels = [(cid, w) for cid, got in zip(launches, replays)
               for w, n in got.items() for _ in range(n)]
    return launches, kernels + [(7, "bgmv")]


@pytest.mark.parametrize("made, replays, want, short", [
    ([STEP] * 16, [MLA] * 16, {"mla_ring_decode": 96, "bgmv": 192}, 0),
    ([STEP] * 16, [LLAMA] * 16, {"ring_decode": 256, "bgmv": 1024}, 0),
    ([BURST] * 2, [{"bgmv": 960}] * 2, {"bgmv": 1920}, 0),
    # one replay of 16 missing from the trace
    ([STEP] * 16, [MLA] * 15, {"mla_ring_decode": 96, "bgmv": 192}, 1),
    ([STEP] * 16, [MLA] * 15 + [{}], {"mla_ring_decode": 96, "bgmv": 192}, 1),
    ([STEP] * 4, [MLA, {"mla_ring_decode": 6, "bgmv": 9}, MLA,
                  {"mla_ring_decode": 2, "bgmv": 12}],
     {"mla_ring_decode": 24, "bgmv": 48}, 2),
    ([BURST], [{"bgmv": 960}], {"bgmv": 960}, 0),
    ([], [], {}, 0),
], ids=["mla_whole", "llama_whole", "bursts_whole", "launch_lost",
        "replay_lost", "replays_partly_lost", "one_replay", "no_calls"])
def test_calls_launch_the_fullest_replay(made, replays, want, short):
    got, got_short = chip_smoke.replay_launches(made, *trace(replays))
    assert (got, got_short) == (want, short)


@pytest.mark.parametrize("counted, replays", [
    ({"mla_ring_decode": 96, "bgmv": 204}, [MLA] * 16),    # a delta too high
    ({"mla_ring_decode": 96, "bgmv": 180}, [MLA] * 16),    # a replay uncounted
    ({"mla_ring_decode": 90, "bgmv": 180}, [MLA] * 15),    # a call uncounted
    ({"mla_ring_decode": 96, "bgmv": 192}, [{"mla_ring_decode": 6}] * 16),
], ids=["delta_too_high", "replay_uncounted", "call_uncounted",
        "kernel_absent_from_every_replay"])
def test_bookkeeping_faults_still_disagree(counted, replays):
    got, _ = chip_smoke.replay_launches([STEP] * 16, *trace(replays))
    assert got != counted


def test_one_graph_a_window():
    with pytest.raises(ValueError, match="several graphs"):
        chip_smoke.replay_launches([STEP, BURST], *trace([MLA, MLA]))


@pytest.mark.parametrize("kernel, wrapper", [
    ("void (anonymous namespace)::bgmv_kernel<float, float, false>(Args)", "bgmv"),
    ("(anonymous namespace)::mla_merge_splits((anonymous namespace)::Args, int)",
     "mla_ring_decode"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x32_8x5_nn_align1>(Params)", None),
], ids=["bgmv", "mla_merge", "library"])
def test_wrapper_of(kernel, wrapper):
    assert chip_smoke.wrapper_of(kernel) == wrapper
