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

A step is a sequence of device operations with no host synchronisation;
the host only admits requests, picks the step width (the prefill chunk while
any slot is prefilling, else a burst of ``poll_every`` width-1 steps) and
reads the completion flags once per burst.

Sampling noise comes from one ``torch.Generator`` per sampling request,
seeded from ``(seed, uid)``: outputs are invariant to slot placement and
admission order.  The streams are not the reference's ``fold_in`` streams.

With ``record_steps=True`` the engine logs every step's width, its time
(CUDA events on the card, so no host synchronisation per step) and the
number of tokens it emitted; :meth:`ServeEngine.step_log` reads the log.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.layers import check_decode_impl
from repro_torch.serve import kvcache as Kv
from repro_torch.serve.adapters import AdapterRegistry, attach


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
    ``argmax(masked + gumbel)`` is a categorical draw."""
    V = logits.shape[-1]
    lf = logits.float()
    greedy = lf.argmax(dim=-1)
    lt = lf / temperature.clamp_min(1e-6)[:, None]
    sorted_lt = lt.sort(dim=-1, descending=True).values
    ninf = torch.tensor(float("-inf"), device=lf.device)
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


def _request_seed(seed: int, uid: int) -> int:
    return int(np.random.SeedSequence((seed, uid)).generate_state(1)[0])


class ServeEngine:
    """One model, B slots, one ring cache, a registry of adapters or a
    single-tenant adapter tree.  ``decode_impl`` picks the attention
    interior (``"dense"`` | ``"kernel"``); ``lora_impl`` the paged LoRA
    delta (``"kernel"`` with the kernel interior, else ``"plain"``)."""

    def __init__(self, cfg: ModelConfig, params: Any, adapters: Any = None,
                 batch_slots: int = 4, capacity: int = 256,
                 kv_dtype: Optional[torch.dtype] = None, seed: int = 0,
                 prefill_chunk: int = 8, max_tokens_cap: int = 1024,
                 decode_impl: str = "dense",
                 registry: Optional[AdapterRegistry] = None,
                 lora_impl: Optional[str] = None, device: DeviceLike = None,
                 record_steps: bool = False):
        check_decode_impl(decode_impl)
        if registry is not None and adapters is not None:
            raise ValueError("pass a single-tenant adapter tree OR a "
                             "multi-tenant registry, not both")
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
            "adapter_ids": z(torch.int32),     # slot -> adapter id (0 = base)
        }
        self._gens: List[Optional[torch.Generator]] = [None] * B
        self.slots: List[Optional[Request]] = [None] * B
        self._pending: List[Request] = []
        self._uid = 0
        self._host_left: Dict[int, int] = {}    # slot -> prompt tokens left
        self.steps_run = 0                      # engine steps, bursts included
        # (width, start, end, tokens emitted) per step while recording
        self._steps: Optional[List] = [] if record_steps else None

    # -- public API -----------------------------------------------------------
    def step_log(self) -> List[Dict[str, Any]]:
        """Every recorded step as ``{"width", "ms", "emitted"}``: its token
        width, its time (device time between CUDA events on the card, host
        time on the CPU) and the tokens it emitted.  Synchronises once."""
        if self._steps is None:
            raise RuntimeError("the engine was built without record_steps=True")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return [{"width": C,
                 "ms": (a.elapsed_time(b) if isinstance(a, torch.cuda.Event)
                        else (b - a) * 1e3),
                 "emitted": int(n)} for C, a, b, n in self._steps]

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
        self._gens[i] = None
        self.slots[i] = None
        self._host_left.pop(i, None)

    def run(self, max_steps: int = 1000,
            poll_every: int = 8) -> Dict[int, List[int]]:
        """Run until every submitted request completes (or ``max_steps``
        engine steps elapse; stragglers are reported with their partial
        output and freed).  Pure-decode phases run ``poll_every`` width-1
        steps back to back and read the completion flags once."""
        results: Dict[int, List[int]] = {}
        steps = 0
        while steps < max_steps:
            self._admit()
            if all(s is None for s in self.slots) and not self._pending:
                break
            prefilling = self._prefilling()
            if (not prefilling and poll_every > 1
                    and max_steps - steps >= poll_every):
                stochastic = self._stochastic()
                for _ in range(poll_every):
                    self._step(1, stochastic)
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

    def run_steps(self, steps: int) -> Dict[int, List[int]]:
        """Advance exactly ``steps`` engine steps without draining; returns
        the requests that completed."""
        results: Dict[int, List[int]] = {}
        for _ in range(steps):
            self._admit()
            if all(s is None for s in self.slots) and not self._pending:
                break
            self._engine_step()
            self._poll(results)
        return results

    # -- internals -------------------------------------------------------------
    def _adapters(self):
        if self.registry is not None:
            return attach(self.registry.device_state,
                          self._state["adapter_ids"], impl=self.lora_impl)
        return self.adapters

    def _step(self, C: int, stochastic: bool) -> None:
        """One engine step of token width ``C``; device work only."""
        start = self._mark() if self._steps is not None else None
        st = self._state
        dev = self.device
        active = st["active"]
        t = torch.arange(C, device=dev)[None, :]
        consumed, plen = st["consumed"], st["prompt_len"]
        remaining = (plen - consumed).clamp_min(0)
        prefilling = active & (remaining > 0)
        n_pre = remaining.clamp_max(C)
        pcap = st["prompt_buf"].shape[1]
        gidx = (consumed[:, None] + t).clamp(0, pcap - 1)
        pre_toks = st["prompt_buf"].gather(1, gidx)
        dec_toks = torch.nn.functional.pad(st["last_token"][:, None], (0, C - 1))
        toks = torch.where(prefilling[:, None], pre_toks, dec_toks)
        n_tok = torch.where(prefilling, n_pre,
                            active.to(torch.int64)).to(torch.int32)

        lg, self.cache = T.decode(self.cfg, self.params, self.cache,
                                  {"tokens": toks}, self._adapters(),
                                  n_tokens=n_tok, decode_impl=self.decode_impl)
        last = (n_tok.long() - 1).clamp(0, C - 1)
        logits = lg.gather(1, last[:, None, None].expand(-1, 1, lg.shape[-1]))[:, 0]

        consumed = consumed + torch.where(prefilling, n_pre, 0)
        do_sample = active & (consumed >= plen)
        if stochastic:
            tok = sample_token(logits, st["temperature"], st["top_k"],
                               st["top_p"], self._gumbel(logits.shape[-1]))
        else:
            tok = logits.argmax(dim=-1)

        hit_stop = tok == st["stop_token"]
        emit = do_sample & ~hit_stop
        gc = st["gen_count"]
        ocap = st["out_buf"].shape[1]
        sel = ((torch.arange(ocap, device=dev)[None, :]
                == gc.clamp(0, ocap - 1)[:, None]) & emit[:, None])
        out_buf = torch.where(sel, tok[:, None], st["out_buf"])
        gc = gc + emit.long()
        finished = do_sample & (hit_stop | (gc >= st["max_tokens"]))
        self._state = dict(st, active=active & ~finished,
                           last_token=torch.where(emit, tok, st["last_token"]),
                           consumed=consumed, gen_count=gc, out_buf=out_buf)
        self.steps_run += 1
        if start is not None:
            self._steps.append((C, start, self._mark(), emit.sum()))

    def _mark(self):
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _gumbel(self, V: int) -> torch.Tensor:
        """(B, V) Gumbel noise: each sampling slot draws from its request's
        own generator (one draw per step it is resident), greedy slots get
        zeros (their token is the argmax whatever the noise)."""
        rows = []
        for g in self._gens:
            if g is None:
                rows.append(torch.zeros(V, device=self.device))
            else:
                u = torch.rand(V, generator=g, device=self.device)
                rows.append(-torch.log(-torch.log(u.clamp_min(1e-20))))
        return torch.stack(rows)

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
        for i, req in admitted:
            self._gens[i] = (torch.Generator(device=dev).manual_seed(
                _request_seed(self.seed, req.uid))
                if req.params.temperature > 0.0 else None)

    def _stochastic(self) -> bool:
        """Whether any outstanding request samples; if none does, the step
        takes a plain argmax and draws no noise."""
        outstanding = self._pending + [s for s in self.slots if s is not None]
        return any(r.params.temperature > 0.0 for r in outstanding)

    def _prefilling(self) -> bool:
        return any(self.slots[i] is not None and self._host_left.get(i, 0) > 0
                   for i in range(self.B))

    def _engine_step(self, width: Optional[int] = None):
        if width is None:
            width = self.chunk if self._prefilling() else 1
        self._step(width, self._stochastic())
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
            self._gens[i] = None
            self._host_left.pop(i, None)

    def _drain(self, results: Dict[int, List[int]]):
        """Timed-out slots: report partial output, free the slot and
        deactivate it on the device."""
        stragglers = [i for i, s in enumerate(self.slots) if s is not None]
        if not stragglers:
            return
        self._collect(stragglers, results)
        self._state["active"][torch.as_tensor(stragglers, device=self.device)] = False
