"""RWKV6 "Finch" layer (port of ``repro.models.rwkv``): data-dependent
token shift (ddlerp) and decay, the per-head WKV state recurrence, group
norm, gating, and the squared-ReLU channel mix (arXiv:2404.05892).

Three routes through the recurrence, as in the reference: the O(1) decode
update of a carried state, the ``wkv6`` kernel over a whole sequence
(``use_kernel``) and the loop over time ``wkv_scan`` otherwise.
:func:`recurrence_route` picks one.  The kernel has no backward (nor has
the reference's), so a call that differentiates (grad mode on and an
adapter leaf that requires grad: a train step) takes ``wkv_scan`` even
with ``use_kernel``, as the reference's train step, which runs without
kernels, does.  With ``use_kernel`` the LoRA projections go through
``lora_matmul`` on every route, as the dense path's do; paged multi-tenant
adapters go through ``bgmv`` (``lora_proj``).

Parameters are stacked ``(L, ...)`` dicts under the reference's keys.  The
decode state keeps the reference's dtypes (``tm_x``/``cm_x`` fp32, ``wkv``
fp32), and decode promotes as the reference's jnp code does: in a bf16
model the shifted token is fp32, so the token shift, ddlerp and the
projections of the mixed inputs compute in fp32 against the bf16 weights
(:func:`repro_torch.peft.lora.matmul`); the full-sequence forward shifts
in zeros of the activations' dtype and stays in it.

The decode path takes ``tp``, a serve mesh's ``model`` axis
(:class:`repro_torch.topology.serve.ModelParallel`), and runs head
parallel on the rank's Megatron shards: ``wr wk wv wg`` and ``wck wcr``
column-parallel (the rank's H/m heads, its ``d_ff``/m channels),
``wo`` and ``wcv`` row-parallel with one ``all_reduce`` each.  The rank's
heads take their own decay (``w0``, ``wd2``'s columns), bonus ``u`` and
group-norm weights, cut from the replicated leaves; the group norm is per
head, so it needs no collective.  ``dd_w1`` and ``wd1`` are
column-parallel under the rules but their outputs feed a ``tanh`` and a
replicated product whole, so they are gathered after the projection, as
``wcr``'s output is before it gates the reduced ``wcv`` output.  The WKV
state is the rank's ``(B, H/m, hd, hd)``; ``tm_x`` and ``cm_x`` stay whole.

The full-sequence path takes ``tp``, a train mesh
(:class:`repro_torch.topology.train.TrainParallel`), in the same layout
under autograd: each mix takes its input through one ``copy``, so all it
computes from it (the token shift, ``ddlerp``, the decay) is the rank's
part of the gradient; ``dd_w1`` and ``wd1``'s outputs are made whole by
``gather`` (their gradients are parts: the reduce-scatter sums them) and
``wcr``'s by ``join`` (it gates the reduced, replicated output: its
gradient is whole on every rank); ``wo`` and ``wcv`` end in ``reduce``.
The recurrence runs on the rank's H/m heads: ``wkv_scan`` under grad, the
``wkv6`` kernel in eval and prefill (:func:`recurrence_route`).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.layers import _proj, dense_init
from repro_torch.peft.lora import COL, ROW

Params = Dict[str, Any]

#: the reference's loop over time; returns (y, final state), both fp32
wkv_scan = kref.wkv6_scan


def init_rwkv6(cfg: ModelConfig, generator: torch.Generator, L: int,
               dtype: torch.dtype) -> Params:
    """Stacked ``(L, ...)`` weights of ``L`` RWKV6 layers with the
    reference's distributions; ``w0`` and ``u`` in fp32, the rest in
    ``dtype``."""
    d, ff, dl = cfg.d_model, cfg.d_ff, cfg.rwkv_decay_lora
    H, hd = cfg.num_rwkv_heads, cfg.rwkv_head_dim
    dev = generator.device

    def uniform(*shape):
        return torch.rand((L,) + shape, generator=generator, device=dev).to(dtype)

    def normal(*shape, std):
        return (torch.randn((L,) + shape, generator=generator, device=dev)
                * std).to(dtype)

    def full(shape, value, dt=dtype):
        return torch.full((L,) + shape, value, dtype=dt, device=dev)

    def dense(din, dout):
        return dense_init(generator, (L, din, dout), din, dtype)

    return {
        # time mix
        "mu_x": uniform(d),
        "mu": uniform(5, d),                      # r, k, v, w, g
        "dd_w1": dense(d, 5 * dl),
        "dd_w2": normal(5, dl, d, std=0.02),
        "wr": dense(d, d), "wk": dense(d, d), "wv": dense(d, d),
        "wg": dense(d, d), "wo": dense(d, d),
        "w0": full((d,), -6.0, torch.float32),    # decay base (pre -exp)
        "wd1": dense(d, dl),
        "wd2": normal(dl, d, std=0.02),
        "u": full((H, hd), 0.0, torch.float32),   # time-first bonus
        "ln_x_w": full((d,), 1.0),
        "ln_x_b": full((d,), 0.0),
        # channel mix
        "mu_ck": uniform(d),
        "mu_cr": full((d,), 0.5),
        "wck": dense(d, ff),
        "wcv": dense(ff, d),
        "wcr": dense(d, d),
    }


def _shift(x: torch.Tensor, last=None) -> torch.Tensor:
    """Token shift: x_{t-1}; the first position gets ``last`` (or zeros)."""
    prev = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([prev, x[:, :-1]], dim=1)


def _whole(tp, y: torch.Tensor, width: int, join: bool = False
           ) -> torch.Tensor:
    """A column-parallel output made whole (gathered where the rank holds
    a cut of its ``width`` columns): by ``gather`` where it feeds the
    rank's own work, by ``join`` (with ``join`` set) where it feeds work
    every rank does whole (:mod:`repro_torch.topology.train`)."""
    if tp is None or y.shape[-1] == width:
        return y
    return tp.join(y) if join else tp.gather(y)


def _ddlerp(p: Params, x, xx, tp=None) -> torch.Tensor:
    """Data-dependent lerp producing the five mixed inputs (r,k,v,w,g):
    (B,S,5,d)."""
    B, S, _ = x.shape
    base = x + xx * p["mu_x"]
    dl = p["dd_w2"].shape[-2]
    h = _whole(tp, _proj(base, p["dd_w1"], None, False, tp, COL), 5 * dl)
    h = torch.tanh(h.float()).reshape(B, S, 5, dl)
    off = torch.einsum("bsfl,fld->bsfd", h.to(x.dtype), p["dd_w2"])
    return x[:, :, None] + xx[:, :, None] * (p["mu"][None, None] + off)


def _decay(p: Params, xw, tp=None) -> torch.Tensor:
    """Data-dependent per-channel log-decay w < 0, fp32: (B,S,d) (the
    rank's d/m channels under ``tp``)."""
    h = _whole(tp, _proj(xw, p["wd1"], None, False, tp, COL),
               p["wd2"].shape[-2])
    wd2, w0 = p["wd2"], p["w0"]
    if tp is not None:
        wd2, w0 = tp.local(wd2), tp.local(w0)
    return -torch.exp(w0 + torch.tanh(h.float()) @ wd2.float())


def _group_norm(x, w, b, H: int, eps: float) -> torch.Tensor:
    """Per-head layer norm of x (B,S,d) fp32."""
    B, S, d = x.shape
    xh = x.reshape(B, S, H, d // H)
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, unbiased=False, keepdim=True)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return xh.reshape(B, S, d) * w + b


def _requires_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    return isinstance(tree, torch.Tensor) and tree.requires_grad


def recurrence_route(adapters, state=None, use_kernel: bool = False) -> str:
    """The route of one time mix through the WKV recurrence: ``"decode"``
    (a carried state, one token), ``"kernel"`` (the ``wkv6`` kernel: a
    whole sequence with ``use_kernel`` in a call that does not
    differentiate) or ``"scan"`` (``wkv_scan``: without ``use_kernel``, or
    with grad mode on and an adapter leaf that requires grad)."""
    if state is not None:
        return "decode"
    if use_kernel and not (torch.is_grad_enabled() and _requires_grad(adapters)):
        return "kernel"
    return "scan"


def time_mix(cfg: ModelConfig, p: Params, x, adapters=None, state=None,
             use_kernel: bool = False, tp=None):
    """x: (B,S,d).  ``state``: None (full sequence) or one layer's decode
    state ``{"tm_x", "wkv", ...}`` (then S = 1).  Returns (out (B,S,d), new
    state ``{"tm_x", "wkv"}`` or None).  ``tp``: head parallel on the
    rank's shards (decode, or a train mesh's full sequence; the module
    docstring)."""
    B, S, _ = x.shape
    H, hd = cfg.num_rwkv_heads, cfg.rwkv_head_dim
    u, ln_w, ln_b = p["u"], p["ln_x_w"], p["ln_x_b"]
    if tp is not None:
        H = H // tp.size
        u, ln_w, ln_b = tp.local(u, 0), tp.local(ln_w), tp.local(ln_b)
        x = tp.copy(x)
    d = H * hd
    a = adapters or {}
    last = state["tm_x"] if state is not None else None
    xx = _shift(x, last) - x
    xr, xk, xv, xw, xg = _ddlerp(p, x, xx, tp).unbind(2)
    r = _proj(xr, p["wr"], a.get("wr"), use_kernel, tp, COL).reshape(B, S, H, hd)
    k = _proj(xk, p["wk"], a.get("wk"), use_kernel, tp, COL).reshape(B, S, H, hd)
    v = _proj(xv, p["wv"], a.get("wv"), use_kernel, tp, COL).reshape(B, S, H, hd)
    g = F.silu(_proj(xg, p["wg"], a.get("wg"), use_kernel, tp, COL).float())
    w = _decay(p, xw, tp).reshape(B, S, H, hd)

    route = recurrence_route(a, state, use_kernel)
    if route == "decode":                      # O(1) decode update
        s = state["wkv"]                                    # (B,H,hd,hd) fp32
        rt, kt, vt = (t[:, 0].float() for t in (r, k, v))
        kv = kt[..., :, None] * vt[..., None, :]
        y = torch.einsum("bhk,bhkv->bhv", rt, s + u[..., None] * kv)[:, None]
        new_state = {"tm_x": x[:, -1],
                     "wkv": torch.exp(w[:, 0])[..., None] * s + kv}
    elif route == "kernel":
        y = kops.wkv6(r, k, v, w, u)
        new_state = None
    else:
        y, _ = wkv_scan(r, k, v, w, u)
        new_state = None

    y = _group_norm(y.reshape(B, -1, d), ln_w.float(), ln_b.float(), H,
                    cfg.norm_eps)
    y = (y * g).to(x.dtype)
    out = _proj(y, p["wo"], a.get("wo"), use_kernel, tp, ROW)
    return (out if tp is None else tp.reduce(out)), new_state


def channel_mix(cfg: ModelConfig, p: Params, x, adapters=None, state=None,
                use_kernel: bool = False, tp=None):
    """Squared-ReLU channel mix with a sigmoid receptance gate.  Returns
    (out (B,S,d), ``{"cm_x"}`` or None).  ``tp``: ``wck`` column- and
    ``wcv`` row-parallel (one ``all_reduce``), ``wcr``'s output gathered
    (``join``) before it gates the reduced output."""
    a = adapters or {}
    if tp is not None:
        x = tp.copy(x)
    last = state["cm_x"] if state is not None else None
    xx = _shift(x, last) - x
    xk = x + xx * p["mu_ck"]
    xr = x + xx * p["mu_cr"]
    k = _proj(xk, p["wck"], a.get("wck"), use_kernel, tp, COL)
    k = torch.square(F.relu(k.float())).to(x.dtype)
    r = _whole(tp, _proj(xr, p["wcr"], a.get("wcr"), use_kernel, tp, COL),
               x.shape[-1], join=True)
    v = _proj(k, p["wcv"], a.get("wcv"), use_kernel, tp, ROW)
    if tp is not None:
        v = tp.reduce(v)
    out = (torch.sigmoid(r.float()) * v.float()).to(x.dtype)
    return out, ({"cm_x": x[:, -1]} if state is not None else None)


def rwkv6_init_state(cfg: ModelConfig, batch: int, device,
                     dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """One layer's zero decode state: the last token of each mix and the
    (B, H, hd, hd) fp32 WKV state."""
    d, H, hd = cfg.d_model, cfg.num_rwkv_heads, cfg.rwkv_head_dim
    return {
        "tm_x": torch.zeros((batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
        "cm_x": torch.zeros((batch, d), dtype=dtype, device=device),
    }
