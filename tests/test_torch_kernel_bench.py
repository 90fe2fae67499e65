"""The port's kernel bench (``repro_torch.benchmarks.kernel_bench``) on the
CPU at tiny sizes: the serve step's live-memory check passes for the
streamed route and finds the dense route's buffers, the report carries the
reference's keys (``benchmarks/kernel_bench.py``), the analytic decode
bytes are the reference's, and ``run --only kernels --device cpu`` runs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import kernel_bench as jbench  # noqa: E402
from repro_torch.benchmarks import kernel_bench as tbench  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: the suite runs files on parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("B,C,cap", [(4, 8, 256), (2, 4, 384)])
def test_live_memory_check_finds_dense_buffers_only(B, C, cap):
    rep = tbench.serve_step_live_memory_check(B=B, C=C, cap=cap, device="cpu")
    H, K = tbench.DEC_MODEL.num_heads, tbench.DEC_MODEL.num_kv_heads
    assert rep["checked_buffers"] == [f"f32[{B},{H},{C},{cap}]",
                                      f"f32[{B},{K},{H // K},{C},{cap}]",
                                      f"pred[{B},{C},{cap}]"]
    assert rep["dense"]["materialized_buffers"] == rep["checked_buffers"]
    assert rep["streamed"]["materialized_buffers"] == []
    assert rep["dense"]["peak_bytes"] is None          # measured on the card


def test_live_memory_check_raises_on_a_violation(monkeypatch):
    """A streamed route that forms the dense scores is caught."""
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "ring_flash_decode",
                        lambda q, k, v, pos, length, n, window=0, k_scale=None,
                        v_scale=None: tbench.ref.ring_decode_ref(
                            q, k, v, pos, length, n, window=window))
    with pytest.raises(AssertionError, match="streamed serve step creates"):
        tbench.serve_step_live_memory_check(device="cpu")


def test_decode_section_keys_and_bytes_match_reference():
    ours = tbench.bench_decode(np.random.default_rng(0), B=2, C=2, H=4, K=2,
                               hd=16, cap=200, block=64, device="cpu")
    ref = jbench.bench_decode(np.random.default_rng(0), B=2, C=2, H=4, K=2,
                              hd=16, cap=200, block=64)
    assert set(ref) <= set(ours) and ours["device"] == "cpu"
    assert "kernel_fp32" not in ours                  # the kernel runs on the card
    for arm in ("dense_fp32", "streamed_fp32", "dense_int8", "streamed_int8"):
        assert set(ours[arm]) == set(ref[arm])
        assert ours[arm]["analytic_hbm_bytes"] == ref[arm]["analytic_hbm_bytes"]
        assert ours[arm]["live_score_bytes"] == ref[arm]["live_score_bytes"]
        assert ours[arm]["us_per_call"] > 0
    for args in ((8, 8, 8, 2, 64, 2048, 128), (3, 1, 4, 1, 16, 100, 64)):
        for int8 in (False, True):
            got, want = tbench.decode_bytes(*args, int8), jbench.decode_bytes(*args, int8)
            assert {k: got[k] for k in ("dense", "streamed")} == \
                {k: want[k] for k in ("dense", "streamed")}
            assert got["kernel"] == got["streamed"]


def test_report_keys_match_reference(capsys):
    rep = tbench.report(device="cpu", cap=128, log=print)
    assert set(rep) == {"backend", "kernels", "decode", "serve_step_live_memory"}
    assert rep["backend"] == "cpu"
    assert [r["name"] for r in rep["kernels"]] == [
        f"kernel/{n}" for n in ("lora_matmul", "flash_attention", "wkv6",
                                "adapter_gram")]
    for r in rep["kernels"]:
        assert "kernel_us=not measured" in r["derived"] and "h100_bound_us=" in r["derived"]
    out = capsys.readouterr().out
    assert "serve-step live-memory check" in out and "decode[int8]" in out


def test_harness_runs_kernels_on_cpu(capsys):
    from repro_torch.benchmarks import run
    run.main(["--only", "kernels", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert [ln.split(",")[0] for ln in lines[1:]] == [
        "kernel/lora_matmul", "kernel/flash_attention", "kernel/wkv6",
        "kernel/adapter_gram"]
