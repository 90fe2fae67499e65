"""The port's serve bench (``repro_torch.benchmarks.serve_bench``) on the
CPU at a tiny size: the report carries the reference's keys
(``benchmarks/serve_bench.py``), every arm serves every token, the engines'
``trace_counts`` stay fixed across passes and registry churn, the mesh axis
serves at mesh 1 and 2 with every rank on mesh 1's tokens, and the eager
baseline loop emits
the engine's greedy tokens.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import serve_bench as sb  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.engine import SamplingParams, ServeEngine  # noqa: E402

TINY = ["--smoke", "--device", "cpu", "--slots", "2", "--requests", "3",
        "--prompt-len", "6", "--gen", "4", "--chunk", "4"]
# the keys of the reference's report and of its parts
REPORT_KEYS = {"config", "results", "decode_impl_axis", "multi_adapter_axis",
               "mesh_axis", "speedup_jit_vs_eager", "speedup_chunked_vs_width1",
               "trace_counts"}
CONFIG_KEYS = {"model", "batch_slots", "requests", "prompt_len", "gen",
               "prefill_chunk", "smoke", "backend"}
ARM_KEYS = {"wall_s", "tokens", "tok_per_s", "decode_impl"}


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: the suite runs files on parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    torch.set_num_threads(1)
    path = tmp_path_factory.mktemp("bench") / "serve.json"
    rep = sb.main(TINY + ["--json", str(path)])
    assert json.loads(path.read_text()) == json.loads(json.dumps(rep))
    return rep


def test_report_keys_match_reference(report):
    assert set(report) == REPORT_KEYS
    assert set(report["config"]) == CONFIG_KEYS
    assert report["config"]["backend"] == "cpu" and report["config"]["smoke"]
    assert list(report["results"]) == ["eager", "jit_chunk1", "jit_chunk4",
                                       "jit_chunk4_streamed"]
    assert all(set(r) == ARM_KEYS for r in report["results"].values())
    assert set(report["decode_impl_axis"]) == {"dense", "streamed",
                                               "speedup_streamed_vs_dense"}
    multi = report["multi_adapter_axis"]
    assert set(multi) == {"adapters_1", "adapters_8", "adapters_32",
                          "slowdown_32_vs_1", "retraces_stable_under_churn"}
    assert set(multi["adapters_8"]) == {"wall_s", "tokens", "tok_per_s",
                                        "live_adapters", "ranks", "trace_counts"}


def test_every_arm_serves_every_token(report):
    want = 3 * 4
    assert all(r["tokens"] == want for r in report["results"].values())
    assert all(report["multi_adapter_axis"][f"adapters_{n}"]["tokens"] == want
               for n in (1, 8, 32))
    assert report["results"]["jit_chunk4_streamed"]["decode_impl"] == "streamed"


def test_captures_fixed_across_passes_and_churn(report):
    tc = report["trace_counts"]
    assert set(tc) == {"jit_chunk1", "jit_chunk4", "jit_chunk4_streamed"}
    assert all(v == 1 for c in tc.values() for v in c.values())
    assert "(4, 'sampled')" in tc["jit_chunk4"]
    assert "(1, 'sampled')" in tc["jit_chunk1"]
    assert report["multi_adapter_axis"]["retraces_stable_under_churn"] is True


def test_mesh_axis_skipped_naming_its_item(report):
    """The mesh axis runs since the multi-device slice: mesh 1 here and
    mesh 2 on a gloo world of two ranks, every rank emitting mesh 1's
    tokens, with the row-parallel all_reduces counted."""
    axis = report["mesh_axis"]
    assert set(axis) == {"mesh1", "mesh2"}
    assert all(a["tokens_match_mesh1"] and a["tok_per_s"] > 0
               for a in axis.values())
    assert axis["mesh1"]["all_reduces"] == 0 < axis["mesh2"]["all_reduces"]
    assert axis["mesh2"]["backend"] == "gloo"


def test_eager_loop_emits_the_engine_greedy_tokens():
    """The first wave (one request a slot): the seed loop, as the
    reference's, never wipes a slot's cache rows, so a later occupant reads
    its predecessor's keys and only the first wave is comparable."""
    cfg = sb.SMOKE_MODEL
    params = T.init(cfg, 0, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, 5).tolist() for _ in range(3)]
    sp = SamplingParams(max_tokens=5)
    eager = sb.EagerLoop(cfg, params, 2, 16, device="cpu")
    eng = ServeEngine(cfg, params, batch_slots=2, capacity=16, prefill_chunk=1,
                      device="cpu")
    ue = [eager.submit(p, sp) for p in prompts]
    ug = [eng.submit(p, sp) for p in prompts]
    got, want = eager.run(), eng.run()
    assert [got[u] for u in ue[:2]] == [want[u] for u in ug[:2]]
    assert all(len(got[u]) == 5 for u in ue)
