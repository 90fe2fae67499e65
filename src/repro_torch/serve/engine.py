"""Continuous-batching serving engine (port of ``repro.serve.engine``).

The engine owns a fixed batch of B slots against one ring KV cache with
per-slot positions.  Requests are admitted into free slots (the slot's
cache rows are wiped on admission).  Every engine step

  * feeds each active slot either a whole prompt chunk (chunked prefill,
    ``prefill_chunk`` tokens) or its last sampled token,
  * masks inactive slots (``n_tokens = 0``: their cache rows never move),
  * samples the next token for every row that finished its prompt with
    branch-free masked math (greedy / temperature / top-k / top-p),
  * applies stop / max-token completion (the stop token is not emitted) and
    writes emitted tokens into an on-device output buffer.

A step is a sequence of device operations with no host synchronisation
that writes into the engine's own tensors (:func:`_build_engine_step`), and
a decode burst is ``poll_every`` of them (:func:`_build_engine_burst`).  On
the card each shape is captured once into a CUDA graph and replayed, so a
step or a burst is one host call; on the CPU the same functions run as they
are.  The host only admits requests, picks the shape (the prefill chunk
while any slot is prefilling, else a burst of ``poll_every`` width-1 steps)
and reads the completion flags once per burst.

Sampling noise is a counter-based hash of each slot's key, set at admission
from ``(seed, uid)``, its draw counter and the vocabulary index
(:func:`gumbel_noise`): outputs are invariant to slot placement and
admission order, and a graph replays them.  The streams are not the
reference's ``fold_in`` streams.

With ``mesh`` (a serve mesh ``(data=1, model=N)`` of
:mod:`repro_torch.topology`) the engine is one rank of a tensor-parallel
server, for every family: params, cache, state and adapters are cut to the
rank's shards once, by the serve rules
(:func:`repro_torch.topology.serve_pspecs`; the embedding and the head stay
replicated, so every rank's sampler sees the same full logits and every
rank emits the same tokens), and each step runs attention, RWKV6 and
Mamba2 head-parallel with one ``all_reduce`` a row-parallel projection and
MoE layers expert parallel (:func:`repro_torch.models.transformer.decode`:
``all_to_all`` in the prefill chunks that the axis divides, one
``all_reduce`` in width-1 steps).  Where a fused leaf needs a finer cut
than a rule's contiguous one, the engine's placement makes it and the
rules stay the reference's ``PartitionSpec``s: Mamba2's ``in_proj``
(``z | x | B | C | dt``), ``conv_w``, ``conv_b``, conv state and
``in_proj`` B pool are cut segment by segment
(:class:`repro_torch.topology.partitioning.Segments`: the rank's heads of
z, x and dt, B and C whole).  Expert stacks that already hold E/N experts
(``T.init(..., experts=)``: a rank that never makes the others' experts)
are kept as this rank's.  A mesh of more than one rank runs the steps
uncaptured: gloo collectives cannot be captured into a CUDA graph (capture
under NCCL is ``ROADMAP.md`` item 9e, for a machine with more than one
card).

With ``record_steps=True`` the engine logs every step's width, its time
(CUDA events around each replay on the card, a burst's time split evenly
over its steps), the number of tokens it emitted (written by the step into
a device buffer) and, under a mesh, its ``all_reduce`` and ``all_to_all``
counts; :meth:`ServeEngine.step_log` reads the log.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.models.layers import check_decode_impl
from repro_torch.serve import kvcache as Kv
from repro_torch.serve.adapters import AdapterRegistry, attach, is_device_state


@dataclasses.dataclass
class SamplingParams:
    temperature: float = 0.0        # 0 => greedy
    top_k: int = 0                  # 0 => no top-k filter
    top_p: float = 1.0              # 1 => no nucleus filter
    max_tokens: int = 32
    stop_token: int = -1            # -1 => never


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    params: SamplingParams
    adapter_id: int = 0             # 0 = base model, no adapter
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def sample_token(logits: torch.Tensor, temperature: torch.Tensor,
                 top_k: torch.Tensor, top_p: torch.Tensor,
                 gumbel: torch.Tensor) -> torch.Tensor:
    """logits (B, V) -> tokens (B,), branch-free per row: greedy where
    ``temperature <= 0``, else a draw from the temperature-scaled
    distribution restricted by top-k and then top-p (on the top-k-filtered,
    renormalised distribution).  ``gumbel`` (B, V) is Gumbel(0, 1) noise:
    ``argmax(masked + gumbel)`` is a categorical draw.  No host copy: it
    runs inside a captured graph."""
    V = logits.shape[-1]
    ninf = float("-inf")
    lf = logits.float()
    greedy = lf.argmax(dim=-1)
    lt = lf / temperature.clamp_min(1e-6)[:, None]
    sorted_lt = lt.sort(dim=-1, descending=True).values
    kth = sorted_lt.gather(1, (top_k - 1).clamp(0, V - 1)[:, None])[:, 0]
    kth = torch.where(top_k > 0, kth, ninf)
    sorted_f = torch.where(sorted_lt < kth[:, None], ninf, sorted_lt)
    cum = torch.softmax(sorted_f, dim=-1).cumsum(dim=-1)
    cut = torch.searchsorted(cum, top_p[:, None].contiguous(), side="left")
    pth = sorted_f.gather(1, cut.clamp(max=V - 1))[:, 0]
    pth = torch.where(top_p < 1.0, pth, ninf)
    masked = torch.where(lt < torch.maximum(kth, pth)[:, None], ninf, lt)
    sampled = (masked + gumbel).argmax(dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled)


_M32 = 0xFFFFFFFF


def mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xor-shift and multiply rounds) of int64
    values in [0, 2^32).  Both multipliers are below 2^31, so every product
    stays below 2^63: the bits are the same on the CPU and the card."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def gumbel_noise(keys: torch.Tensor, draws: torch.Tensor, V: int) -> torch.Tensor:
    """(B, V) Gumbel(0, 1) noise, a counter-based hash of each row's
    ``(key, draw)`` and the vocabulary index: a function of those alone, so
    a request's stream does not depend on its slot, its batch or a graph.
    The uniform has 24 bits, (h + 1/2) / 2^24, never 0 or 1."""
    row = mix32(keys ^ mix32(draws & _M32))                        # (B,)
    col = mix32(torch.arange(V, dtype=torch.int64, device=keys.device))
    h = mix32((row[:, None] + col[None, :]) & _M32)                # (B, V)
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def request_key(seed: int, uid: int) -> int:
    """A request's sampling key in [0, 2^32), from ``(seed, uid)``."""
    return int(np.random.SeedSequence((seed, uid)).generate_state(1)[0])


def _build_engine_step(cfg: ModelConfig, width: int, stochastic: bool = True,
                       decode_impl: str = "dense", lora_impl: str = "plain",
                       tp=None):
    """One engine step of token ``width`` as a function ``step(params,
    adapters, cache, state, emitted=None, i=0)`` that writes its results
    into the tensors it was given: the cache's ring buffers, recurrent
    states and ``pos``/``length``, and the slot state's ``active``,
    ``last_token``, ``consumed``, ``gen_count``, ``out_buf`` and ``draws``
    (and ``emitted[i]``, the tokens the step emitted, when given).  It
    allocates nothing that outlives it and makes no host synchronisation,
    so a CUDA graph can capture it.  ``stochastic=False`` is the greedy-only
    variant (a plain argmax, no noise, no draws).  ``adapters`` is a
    single-tenant adapter tree or a registry's device state, attached
    against ``state["adapter_ids"]`` with ``lora_impl``.  ``tp`` runs the
    layers head-parallel (``cfg`` then holds the rank's head counts)."""
    C = width

    def step(params, adapters, cache, state, emitted=None, i: int = 0):
        if is_device_state(adapters):
            adapters = attach(adapters, state["adapter_ids"], impl=lora_impl)
        active = state["active"]
        t = torch.arange(C, device=active.device)[None, :]
        consumed, plen = state["consumed"], state["prompt_len"]
        remaining = (plen - consumed).clamp_min(0)
        prefilling = active & (remaining > 0)
        n_pre = remaining.clamp_max(C)
        pcap = state["prompt_buf"].shape[1]
        gidx = (consumed[:, None] + t).clamp(0, pcap - 1)
        pre_toks = state["prompt_buf"].gather(1, gidx)
        dec_toks = torch.nn.functional.pad(state["last_token"][:, None], (0, C - 1))
        toks = torch.where(prefilling[:, None], pre_toks, dec_toks)
        n_tok = torch.where(prefilling, n_pre,
                            active.to(torch.int64)).to(torch.int32)

        lg, new_cache = T.decode(cfg, params, cache, {"tokens": toks}, adapters,
                                 n_tokens=n_tok, decode_impl=decode_impl,
                                 tp=tp)
        Kv.write_positions(cache, new_cache)
        last = (n_tok.long() - 1).clamp(0, C - 1)
        logits = lg.gather(1, last[:, None, None].expand(-1, 1, lg.shape[-1]))[:, 0]

        consumed = consumed + torch.where(prefilling, n_pre, 0)
        do_sample = active & (consumed >= plen)
        if stochastic:
            tok = sample_token(logits, state["temperature"], state["top_k"],
                               state["top_p"],
                               gumbel_noise(state["keys"], state["draws"],
                                            logits.shape[-1]))
            state["draws"].add_(do_sample.to(torch.int64))
        else:
            tok = logits.argmax(dim=-1)

        hit_stop = tok == state["stop_token"]
        emit = do_sample & ~hit_stop
        gc = state["gen_count"]
        out_buf = state["out_buf"]
        at = gc.clamp(0, out_buf.shape[1] - 1)[:, None]
        out_buf.scatter_(1, at, torch.where(emit[:, None], tok[:, None],
                                            out_buf.gather(1, at)))
        gc_new = gc + emit.to(torch.int64)
        finished = do_sample & (hit_stop | (gc_new >= state["max_tokens"]))
        state["last_token"].copy_(torch.where(emit, tok, state["last_token"]))
        state["consumed"].copy_(consumed)
        state["gen_count"].copy_(gc_new)
        state["active"].copy_(active & ~finished)
        if emitted is not None:
            emitted[i].copy_(emit.sum())

    return step


def _build_engine_burst(cfg: ModelConfig, steps: int, stochastic: bool = True,
                        decode_impl: str = "dense", lora_impl: str = "plain",
                        tp=None):
    """``steps`` width-1 engine steps as one function over the same
    arguments as :func:`_build_engine_step` (``emitted[i]`` for step
    ``i``).  Finished and inactive rows no-op (``n_tokens = 0``), so a
    fixed burst is safe when a slot completes mid-burst."""
    step = _build_engine_step(cfg, 1, stochastic, decode_impl, lora_impl, tp)

    def burst(params, adapters, cache, state, emitted=None):
        for i in range(steps):
            step(params, adapters, cache, state, emitted, i)

    return burst


def check_tensor_parallel(cfg: ModelConfig, n: int) -> None:
    """Raise ``ValueError`` unless every width that tensor-parallel decode
    cuts on a ``model`` axis of ``n`` ranks divides by ``n``: attention
    heads and KV heads (MLA: its heads, ``q_lora_rank`` and the joint
    latent), ``d_ff`` where a dense MLP, a shared block or RWKV6's channel
    mix cuts it, RWKV6's heads, Mamba2's SSM heads, the experts and
    DeepSeek-V3's shared expert."""
    kinds = {k for k, c in T.layer_plan(cfg) if c}
    widths = {}
    if kinds & {"dense", "moe", "shared"}:
        widths.update(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads)
    if kinds & {"mla_dense", "mla_moe"}:
        widths.update({"num_heads": cfg.num_heads,
                       "q_lora_rank": cfg.q_lora_rank,
                       "kv_lora_rank + qk_rope_head_dim":
                           cfg.kv_lora_rank + cfg.qk_rope_head_dim})
    if kinds & {"dense", "mla_dense", "shared", "rwkv"}:
        widths["d_ff"] = cfg.d_ff
    if kinds & {"moe", "mla_moe"}:
        widths["num_experts"] = cfg.num_experts
        if cfg.num_shared_experts:
            widths["moe_d_ff · num_shared_experts"] = (
                (cfg.moe_d_ff or cfg.d_ff) * cfg.num_shared_experts)
    if "rwkv" in kinds:
        widths["RWKV heads (d_model / rwkv_head_dim)"] = cfg.num_rwkv_heads
    if "mamba" in kinds:
        widths["SSM heads (d_inner / ssm_head_dim)"] = cfg.num_ssm_heads
    bad = {k: v for k, v in widths.items() if v % n}
    if bad:
        raise ValueError(f"a model axis of {n} ranks does not divide "
                         f"{cfg.name!r}'s {bad}: tensor-parallel decode "
                         "needs every width it cuts divisible")


def rank_experts(cfg: ModelConfig, mesh) -> Optional[tuple]:
    """The experts ``[e0, e1)`` this rank of ``mesh`` holds under expert
    parallelism (``T.init``'s ``experts``), or None (no mesh, one rank, no
    experts, or an axis that does not divide them: every expert)."""
    n = mesh.axis_size("model") if mesh is not None else 1
    E = cfg.num_experts
    if n == 1 or not E or E % n:
        return None
    r = mesh.axis_index("model")
    return r * E // n, (r + 1) * E // n


def tensor_parallel_config(cfg: ModelConfig, n: int) -> ModelConfig:
    """The config one rank's layers see: its share of the attention heads
    (RWKV6, Mamba2 and MoE layers take their shares from ``tp``)."""
    if cfg.use_mla:
        return cfg.replace(num_heads=cfg.num_heads // n)
    return cfg.replace(num_heads=cfg.num_heads // n,
                       num_kv_heads=cfg.num_kv_heads // n)


def _fused_specs(cfg: ModelConfig, tree: Any, specs: Any, mesh) -> Any:
    """``specs`` with Mamba2's fused leaves cut segment by segment (the
    weights by :func:`repro_torch.topology.partitioning.fused_pspec`, the
    conv state and the ``in_proj`` B pool likewise) and expert stacks that
    hold E/n experts taken as this rank's (the module docstring); the
    other specs as they are."""
    from repro_torch.topology.partitioning import (fused_pspec, map_with_path,
                                                   mamba_segments)
    zxbcdt, xbc = mamba_segments(cfg)
    n = mesh.axis_size("model")

    def at(path):
        node = specs
        for k in path:
            node = node[k]
        return node

    def fix(path, leaf):
        spec = list(fused_pspec(cfg, mesh, path, at(path)))
        if cfg.family == "hybrid":
            if path[-1] == "conv":
                spec[-1] = xbc
            elif path[-3:] == ("mixer", "in_proj", "B"):
                spec[-2] = zxbcdt
        if (cfg.num_experts and len(path) > 1 and path[-2] == "moe"
                and path[-1] in ("w_gate", "w_up", "w_down")
                and leaf.shape[-3] == cfg.num_experts // n):
            spec = [None] * leaf.ndim
        return tuple(spec)

    return map_with_path(fix, tree)


def placement_specs(cfg: ModelConfig, mesh, params: Any, cache: Any,
                    state: Any, adapters: Any = None) -> Dict[str, Any]:
    """The specs a meshed engine places its trees by: the serve rules
    (:func:`repro_torch.topology.serve_pspecs`) with the embedding and the
    head replicated and, on more than one rank, :func:`_fused_specs`'
    finer cuts."""
    from repro_torch import topology
    trees = {"params": params, "cache": cache, "state": state,
             "adapters": adapters}
    specs = topology.serve_pspecs(mesh, cfg, params, cache, state, adapters)
    for key in ("embed", "lm_head"):
        if key in params:
            specs["params"][key] = (None,) * params[key].ndim
    if mesh.axis_size("model") > 1:
        specs = {k: _fused_specs(cfg, trees[k], specs[k], mesh)
                 if trees[k] is not None else None for k in specs}
    return specs


def _bytes(tree: Any) -> int:
    from repro_torch.topology.partitioning import tree_map
    total = []
    tree_map(lambda t: total.append(t.numel() * t.element_size()), tree)
    return sum(total)


@dataclasses.dataclass
class _EngineFn:
    """A built engine function of ``steps`` steps, with its emitted-count
    buffer; on the card its graph and the launches its capture counted."""
    fn: Callable
    steps: int
    emitted: Optional[torch.Tensor]
    graph: Any = None
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)


class ServeEngine:
    """One model, B slots, one ring cache, a registry of adapters or a
    single-tenant adapter tree.  ``decode_impl`` picks the attention
    interior (``"dense"`` | ``"streamed"`` | ``"kernel"``); ``lora_impl``
    the paged LoRA delta (``"kernel"`` with the kernel interior, else
    ``"plain"``).

    Every tensor a step reads or writes (params, adapters or the registry's
    pools and tables, the cache and the slot state) keeps its address for
    the engine's life; admission, ``reset_slot`` and registry churn write
    into them.  On the card each step shape (width 1 or the prefill chunk,
    greedy or sampled) and each burst shape (``poll_every`` width-1 steps)
    is captured once into a CUDA graph, all in one memory pool, and
    replayed after that; a capture that fails raises.  On the CPU the same
    built functions run uncaptured.  ``trace_counts`` counts the captures
    (builds on the CPU) by ``(width, "greedy" | "sampled")`` and
    ``("burst{n}", mode)``; ``warmup_steps`` the steps run (with every row
    inactive) before captures, outside ``steps_run``.

    ``mesh`` makes the engine one rank of a tensor-parallel server (see the
    module docstring): its steps then run uncaptured on the card too, and
    ``trace_counts`` counts builds, as on the CPU; ``dcfg`` is the config
    the layers see (the rank's head counts), ``tp`` the ``model`` axis
    with its ``all_reduce`` and ``all_to_all`` counts, ``placement`` each
    placed tree's bytes held on this rank and the bytes its specs give
    the rank (``{"params" | "cache" | "state" | "adapters": {"held",
    "expected"}}``)."""

    def __init__(self, cfg: ModelConfig, params: Any, adapters: Any = None,
                 batch_slots: int = 4, capacity: int = 256,
                 kv_dtype: Optional[torch.dtype] = None, seed: int = 0,
                 prefill_chunk: int = 8, max_tokens_cap: int = 1024,
                 decode_impl: str = "dense",
                 registry: Optional[AdapterRegistry] = None,
                 lora_impl: Optional[str] = None, device: DeviceLike = None,
                 record_steps: bool = False, mesh: Any = None):
        check_decode_impl(decode_impl)
        if registry is not None and adapters is not None:
            raise ValueError("pass a single-tenant adapter tree OR a "
                             "multi-tenant registry, not both")
        if device is None and mesh is not None:
            device = mesh.device
        self.device = dev = resolve_device(device)
        if params["embed"].device.type != dev.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {dev}")
        self.cfg = cfg
        self.params = params
        self.adapters = adapters
        self.registry = registry
        self.lora_impl = lora_impl or (
            "kernel" if decode_impl == "kernel" else "plain")
        self.B = B = batch_slots
        self.capacity = capacity
        self.decode_impl = decode_impl
        self.seed = seed
        # RWKV6 (and hybrid) recurrences step one token at a time; attention
        # families take whole chunks through the cached sequence path
        ring_cap = min(capacity, cfg.sliding_window or capacity)
        self.chunk = (1 if cfg.family in ("ssm", "hybrid")
                      else max(1, min(prefill_chunk, ring_cap)))
        self.cache = T.init_cache(cfg, B, capacity, kv_dtype,
                                  prefill_chunk=self.chunk, device=dev)

        def z(dtype, width=None, fill=0):
            shape = (B,) if width is None else (B, width)
            return torch.full(shape, fill, dtype=dtype, device=dev)

        i64 = torch.int64
        self._state: Dict[str, torch.Tensor] = {
            "active": z(torch.bool),
            "last_token": z(i64),
            "consumed": z(i64),
            "prompt_len": z(i64),
            "prompt_buf": z(i64, max(capacity, 1)),
            "gen_count": z(i64),
            "out_buf": z(i64, max(max_tokens_cap, 1)),
            "temperature": z(torch.float32),
            "top_k": z(i64),
            "top_p": z(torch.float32, fill=1.0),
            "max_tokens": z(i64),
            "stop_token": z(i64, fill=-1),
            "keys": z(i64),                     # request_key(seed, uid)
            "draws": z(i64),                    # noise draws taken
            "adapter_ids": z(torch.int32),     # slot -> adapter id (0 = base)
        }
        self.slots: List[Optional[Request]] = [None] * B
        self._pending: List[Request] = []
        self._uid = 0
        self._host_left: Dict[int, int] = {}    # slot -> prompt tokens left
        self.steps_run = 0                      # engine steps, bursts included
        self.warmup_steps = 0                   # steps run before captures
        self.trace_counts: Dict[Any, int] = {}
        self._fns: Dict[Any, _EngineFn] = {}
        # (width, start, end, emitted counts, steps, collectives) per call
        # while recording
        self._steps: Optional[List] = [] if record_steps else None
        self.mesh = mesh
        self.dcfg = cfg
        self.tp = None
        self.placement: Dict[str, Dict[str, int]] = {}
        if mesh is not None:
            self._install_mesh(mesh)
        if dev.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(dev)
            self._tickets = self._reserve_tickets()

    # -- public API -----------------------------------------------------------
    def step_log(self) -> List[Dict[str, Any]]:
        """Every recorded step as ``{"width", "ms", "emitted", "burst",
        "all_reduces", "all_to_alls"}``: its token width, its time (device
        time between CUDA events around the graph's replay on the card,
        host time on the CPU), the tokens it emitted, the steps of its call
        (a burst of ``n`` steps is timed as one and each of its steps gets
        ``ms`` = the burst's time / n, marked ``"burst": n``; 1 for a step
        timed alone) and the collectives it made under a mesh (a burst's
        split evenly; 0 without a mesh).  Synchronises once."""
        if self._steps is None:
            raise RuntimeError("the engine was built without record_steps=True")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out = []
        for C, a, b, emitted, n, (ar, a2a) in self._steps:
            ms = (a.elapsed_time(b) if isinstance(a, torch.cuda.Event)
                  else (b - a) * 1e3)
            out.extend({"width": C, "ms": ms / n, "emitted": int(e), "burst": n,
                        "all_reduces": ar // n, "all_to_alls": a2a // n}
                       for e in emitted.tolist())
        return out

    def submit(self, prompt: List[int],
               params: Optional[SamplingParams] = None,
               adapter_id: int = 0) -> int:
        params = params or SamplingParams()
        if len(prompt) > self._state["prompt_buf"].shape[1]:
            raise ValueError(f"prompt of {len(prompt)} tokens exceeds the "
                             f"engine prompt capacity {self.capacity}")
        if params.max_tokens < 1:
            raise ValueError(f"max_tokens={params.max_tokens} must be >= 1")
        if params.max_tokens > self._state["out_buf"].shape[1]:
            raise ValueError(f"max_tokens={params.max_tokens} exceeds "
                             f"max_tokens_cap={self._state['out_buf'].shape[1]}")
        if adapter_id != 0:
            if self.registry is None:
                raise ValueError(f"adapter_id={adapter_id} requires an "
                                 "engine constructed with a registry")
            if not self.registry.is_live(adapter_id):
                raise KeyError(f"adapter_id={adapter_id} is unknown or "
                               "evicted from the registry")
        self._uid += 1
        self._pending.append(Request(self._uid, list(prompt), params,
                                     adapter_id=adapter_id))
        return self._uid

    def reset_slot(self, i: int) -> None:
        """Abort slot ``i``'s request: its cache rows are wiped and its
        adapter entry goes back to the base id."""
        if self.slots[i] is None:
            raise ValueError(f"slot {i} is not occupied")
        Kv.reset_slot(self.cache, i)
        self._state["active"][i] = False
        self._state["adapter_ids"][i] = 0
        self.slots[i] = None
        self._host_left.pop(i, None)

    def run(self, max_steps: int = 1000,
            poll_every: int = 8) -> Dict[int, List[int]]:
        """Run until every submitted request completes (or ``max_steps``
        engine steps elapse; stragglers are reported with their partial
        output and freed).  Pure-decode phases run ``poll_every`` width-1
        steps as one burst and read the completion flags once."""
        results: Dict[int, List[int]] = {}
        steps = 0
        while steps < max_steps:
            self._admit()
            if all(s is None for s in self.slots) and not self._pending:
                break
            prefilling = self._prefilling()
            if (not prefilling and poll_every > 1
                    and max_steps - steps >= poll_every):
                self._burst(poll_every)
                steps += poll_every
                self._poll(results)
            else:
                width = self.chunk if prefilling else 1
                could_sample = any(
                    self.slots[i] is not None
                    and self._host_left.get(i, 0) <= width
                    for i in range(self.B))
                self._engine_step(width)
                steps += 1
                if could_sample:
                    self._poll(results)
        self._drain(results)
        return results

    def run_steps(self, steps: int, poll_every: int = 1) -> Dict[int, List[int]]:
        """Advance exactly ``steps`` engine steps without draining; returns
        the requests that completed.  With ``poll_every > 1`` pure-decode
        stretches run as bursts of that many steps (as :meth:`run` does),
        polled once a burst."""
        results: Dict[int, List[int]] = {}
        done = 0
        while done < steps:
            self._admit()
            if all(s is None for s in self.slots) and not self._pending:
                break
            if (poll_every > 1 and not self._prefilling()
                    and steps - done >= poll_every):
                self._burst(poll_every)
                done += poll_every
            else:
                self._engine_step()
                done += 1
            self._poll(results)
        return results

    # -- internals -------------------------------------------------------------
    def _adapters_arg(self):
        """A step's ``adapters``: the registry's device state (attached in
        the step against the slots' adapter ids) or the engine's tree."""
        if self.registry is not None:
            return self.registry.device_state
        return self.adapters

    def _install_mesh(self, mesh) -> None:
        """Cut every engine-owned tree to this rank's shards, once, by
        :func:`placement_specs`; the registry keeps only its shard of the
        pages (:meth:`AdapterRegistry.place`).  A one-rank mesh changes
        nothing."""
        from repro_torch import topology
        from repro_torch.topology.partitioning import local_bytes
        from repro_torch.topology.serve import ModelParallel
        n = mesh.axis_size("model")
        if mesh.axis_size("data") != 1 or "pod" in mesh.axis_names:
            raise ValueError(f"a serve mesh is (data=1, model=N); got "
                             f"{mesh.shape}")
        if n > 1:
            check_tensor_parallel(self.cfg, n)
        trees = {"params": self.params, "cache": self.cache,
                 "state": self._state, "adapters": self._adapters_arg()}
        specs = placement_specs(self.cfg, mesh, *trees.values())
        expected = {k: local_bytes(t, specs[k], mesh) for k, t in trees.items()}
        self.params = topology.shard(self.params, specs["params"], mesh)
        self.cache = topology.shard(self.cache, specs["cache"], mesh)
        self._state = topology.shard(self._state, specs["state"], mesh)
        if self.registry is not None:
            self.registry.place(specs["adapters"], mesh)
        elif self.adapters is not None:
            self.adapters = topology.shard(self.adapters, specs["adapters"],
                                           mesh)
        held = {"params": self.params, "cache": self.cache,
                "state": self._state, "adapters": self._adapters_arg()}
        self.placement = {k: {"held": _bytes(held[k]), "expected": expected[k]}
                          for k in trees}
        if n > 1:
            self.tp = ModelParallel(mesh)
            self.dcfg = tensor_parallel_config(self.cfg, n)

    def _reserve_tickets(self):
        """``ring_decode``'s merge counters for the engine's largest call,
        before any capture (a graph keeps the address it captured); the
        hybrid's rings are its shared block's, at chunk 1."""
        cfg = self.dcfg
        if self.decode_impl != "kernel" or cfg.use_mla or cfg.family == "ssm":
            return None
        from repro_torch.kernels import ring_decode
        dev = next(c["k"].device for c in self.cache if "k" in c)
        return ring_decode.reserve_tickets(dev, ring_decode.tickets_bound(
            self.B, self.chunk, cfg.num_heads, cfg.num_kv_heads))

    def _mode(self) -> str:
        return "sampled" if self._stochastic() else "greedy"

    def _step(self, C: int) -> None:
        """One engine step of token width ``C``; device work only."""
        mode = self._mode()
        self._call((C, mode), lambda: _build_engine_step(
            self.dcfg, C, mode == "sampled", self.decode_impl, self.lora_impl,
            self.tp), 1, C)

    def _burst(self, n: int) -> None:
        """``n`` width-1 steps as one call (one graph replay on the card)."""
        mode = self._mode()
        self._call((f"burst{n}", mode), lambda: _build_engine_burst(
            self.dcfg, n, mode == "sampled", self.decode_impl, self.lora_impl,
            self.tp), n, 1)

    def _call(self, key, build: Callable, steps: int, width: int) -> None:
        entry = self._fns.get(key)
        if entry is None:
            emitted = (torch.zeros(steps, dtype=torch.int64, device=self.device)
                       if self._steps is not None else None)
            entry = _EngineFn(build(), steps, emitted)
            if self.device.type == "cuda" and self.tp is None:
                self._capture(entry)
            self.trace_counts[key] = self.trace_counts.get(key, 0) + 1
            self._fns[key] = entry
        start = self._mark() if self._steps is not None else None
        tp0 = self._collectives()
        if entry.graph is not None:
            entry.graph.replay()
            ops.add_launches(entry.launches)
        else:
            entry.fn(self.params, self._adapters_arg(), self.cache,
                     self._state, entry.emitted)
        self.steps_run += steps
        if start is not None:
            made = [b - a for a, b in zip(tp0, self._collectives())]
            self._steps.append((width, start, self._mark(),
                                entry.emitted.clone(), steps, made))

    def _collectives(self):
        """(all_reduces, all_to_alls) made so far by this rank's steps."""
        tp = self.tp
        return (0, 0) if tp is None else (tp.all_reduces, tp.all_to_alls)

    def _capture(self, entry: _EngineFn) -> None:
        """Warm ``entry.fn`` up on a side stream with every row inactive
        (``n_tokens = 0`` leaves the cache and the state as they are; the
        kernels' builds, cached launch queries and library workspaces come
        into being), then capture it into a CUDA graph in the engine's pool
        and record the launches the capture's Python calls counted: the
        capture launches nothing, each replay launches them."""
        st = self._state
        args = (self.params, self._adapters_arg(), self.cache, st, entry.emitted)
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            active = st["active"].clone()
            st["active"].fill_(False)
            entry.fn(*args)
            self.warmup_steps += entry.steps
            before = ops.launch_counts()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
                entry.fn(*args)
            entry.launches = ops.launch_delta(before, ops.launch_counts())
            ops.add_launches(entry.launches, -1)
            st["active"].copy_(active)
        main.wait_stream(self._stream)
        entry.graph = graph

    def _mark(self):
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _admit(self):
        admitted = []
        for i in range(self.B):
            if self.slots[i] is None and self._pending:
                req = self._pending.pop(0)
                self.slots[i] = req
                self._host_left[i] = len(req.prompt)
                admitted.append((i, req))
        if not admitted:
            return
        dev = self.device
        mask = np.zeros(self.B, bool)
        idx = [i for i, _ in admitted]
        mask[idx] = True
        Kv.reset_slots(self.cache, torch.as_tensor(mask, device=dev))
        reqs = [req for _, req in admitted]
        rows = np.zeros((len(reqs), self._state["prompt_buf"].shape[1]), np.int64)
        for r, req in enumerate(reqs):
            rows[r, :len(req.prompt)] = req.prompt
        ix = torch.as_tensor(idx, device=dev)
        st = self._state

        def put(name, vals):
            st[name][ix] = torch.as_tensor(vals, dtype=st[name].dtype, device=dev)

        put("active", [True] * len(reqs))
        put("last_token", [0] * len(reqs))     # empty prompt seeds from token 0
        put("consumed", [0] * len(reqs))
        put("prompt_len", [len(r.prompt) for r in reqs])
        put("prompt_buf", rows)
        put("gen_count", [0] * len(reqs))
        st["out_buf"][ix] = 0
        put("temperature", [r.params.temperature for r in reqs])
        put("top_k", [r.params.top_k for r in reqs])
        put("top_p", [r.params.top_p for r in reqs])
        put("max_tokens", [r.params.max_tokens for r in reqs])
        put("stop_token", [r.params.stop_token for r in reqs])
        put("adapter_ids", [r.adapter_id for r in reqs])
        # per-request noise streams: a function of (seed, uid) only, so
        # sampling is invariant to slot placement
        put("keys", [request_key(self.seed, r.uid) for r in reqs])
        put("draws", [0] * len(reqs))

    def _stochastic(self) -> bool:
        """Whether any outstanding request samples; if none does, the step
        takes a plain argmax and draws no noise.  A sampled request keeps
        the engine in the sampled variant for its whole life, so its draws
        never depend on mode switches."""
        outstanding = self._pending + [s for s in self.slots if s is not None]
        return any(r.params.temperature > 0.0 for r in outstanding)

    def _prefilling(self) -> bool:
        return any(self.slots[i] is not None and self._host_left.get(i, 0) > 0
                   for i in range(self.B))

    def _engine_step(self, width: Optional[int] = None):
        if width is None:
            width = self.chunk if self._prefilling() else 1
        self._step(width)
        for i in range(self.B):
            if self.slots[i] is not None and self._host_left.get(i, 0) > 0:
                self._host_left[i] = max(0, self._host_left[i] - width)

    def _poll(self, results: Dict[int, List[int]]):
        """Read the completion flags: an occupied slot whose device row went
        inactive has finished."""
        active = self._state["active"].cpu().numpy()
        done = [i for i, req in enumerate(self.slots)
                if req is not None and not active[i]]
        if done:
            self._collect(done, results)

    def _collect(self, slot_idx, results: Dict[int, List[int]]):
        gc = self._state["gen_count"].cpu().numpy()
        out = self._state["out_buf"].cpu().numpy()
        for i in slot_idx:
            req = self.slots[i]
            if req is None:
                continue
            req.generated = out[i, :gc[i]].tolist()
            req.done = True
            results[req.uid] = req.generated
            self.slots[i] = None
            self._host_left.pop(i, None)

    def _drain(self, results: Dict[int, List[int]]):
        """Timed-out slots: report partial output, free the slot and
        deactivate it on the device."""
        stragglers = [i for i, s in enumerate(self.slots) if s is not None]
        if not stragglers:
            return
        self._collect(stragglers, results)
        self._state["active"][torch.as_tensor(stragglers, device=self.device)] = False
