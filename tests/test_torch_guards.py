"""Guards of the port's boundaries: ``repro_torch`` never imports ``jax``
or anything of the JAX package ``repro``, and its entry points run on CUDA
unless the caller asks for the CPU — without CUDA they raise instead of
falling back."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).replace(
        ".__init__", "")
    for p in PKG.rglob("*.py"))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_every_module_leaves_jax_out():
    code = ("import importlib, json, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(k for k in sys.modules\n"
            "      if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert len(MODULES) >= 15


def test_entry_points_raise_without_cuda(monkeypatch):
    """With no CUDA device and no explicit device="cpu", every entry point
    raises; with device="cpu" it runs."""
    from repro_torch.configs.llama3p2_1b import SMOKE
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T
    from repro_torch.serve.adapters import AdapterRegistry
    from repro_torch.serve.engine import ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SMOKE.replace(num_layers=1, vocab_size=64)
    params = T.init(cfg, 0, device="cpu")
    template = {"blocks": {0: {"attn": {"wq": {
        "A": torch.zeros(1, 4, 256), "B": torch.zeros(1, 256, 4),
        "scale": torch.ones(1)}}}}}
    calls = [lambda: T.init(cfg, 0), lambda: T.init_cache(cfg, 2, 8),
             lambda: ServeEngine(cfg, params),
             lambda: AdapterRegistry(template),
             lambda: params_from_numpy({"x": [1.0]}),
             lambda: serve("smoke")]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert ServeEngine(cfg, params, device="cpu").device.type == "cpu"
    AdapterRegistry(template, device="cpu")


def test_kernel_wrappers_take_plain_version_only_for_cpu_tensors():
    """A CPU tensor runs the plain version and counts no launch; a tensor
    on another device reaches the CUDA wrapper, whose checks raise before
    any launch (here: the meta device is not CUDA)."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    q = torch.zeros(1, 1, 2, 16)
    kv = torch.zeros(1, 4, 1, 16)
    i = torch.ones(1, dtype=torch.int32)
    ops.ring_decode(q, kv, kv, i, i, i)
    x = torch.zeros(1, 1, 8)
    a, b = torch.zeros(2, 4, 8), torch.zeros(2, 8, 4)
    t, r, s = (torch.zeros(2, 1, dtype=torch.int32),
               torch.zeros(2, dtype=torch.int32), torch.ones(2))
    ops.bgmv(x, a, b, t, r, s, torch.zeros(1, dtype=torch.int32))
    assert ops.launch_counts() == dict.fromkeys(ops.WRAPPERS, 0)
    with pytest.raises(ValueError, match="CUDA"):
        ops.ring_decode(q.to("meta"), kv.to("meta"), kv.to("meta"),
                        i.to("meta"), i.to("meta"), i.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        ops.bgmv(x.to("meta"), a.to("meta"), b.to("meta"), t.to("meta"),
                 r.to("meta"), s.to("meta"),
                 torch.zeros(1, dtype=torch.int32, device="meta"))
    assert ops.launch_counts() == dict.fromkeys(ops.WRAPPERS, 0)
