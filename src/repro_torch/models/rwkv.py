"""RWKV6 "Finch" layer (port of ``repro.models.rwkv``): data-dependent
token shift (ddlerp) and decay, the per-head WKV state recurrence, group
norm, gating, and the squared-ReLU channel mix (arXiv:2404.05892).

Three routes through the recurrence, as in the reference: the O(1) decode
update of a carried state, the ``wkv6`` kernel over a whole sequence
(``use_kernel``) and the loop over time ``wkv_scan`` otherwise.  With
``use_kernel`` the LoRA projections go through ``lora_matmul`` as the dense
path's do; paged multi-tenant adapters go through ``bgmv`` (``lora_proj``).

Parameters are stacked ``(L, ...)`` dicts under the reference's keys.  The
decode state keeps the reference's dtypes (``tm_x``/``cm_x`` fp32, ``wkv``
fp32), and decode promotes as the reference's jnp code does: in a bf16
model the shifted token is fp32, so the token shift, ddlerp and the
projections of the mixed inputs compute in fp32 against the bf16 weights
(:func:`repro_torch.peft.lora.matmul`); the full-sequence forward shifts
in zeros of the activations' dtype and stays in it.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.layers import dense_init
from repro_torch.peft.lora import lora_proj, matmul

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


def _ddlerp(p: Params, x, xx) -> torch.Tensor:
    """Data-dependent lerp producing the five mixed inputs (r,k,v,w,g):
    (B,S,5,d)."""
    B, S, _ = x.shape
    base = x + xx * p["mu_x"]
    dl = p["dd_w1"].shape[1] // 5
    h = torch.tanh(matmul(base, p["dd_w1"]).float()).reshape(B, S, 5, dl)
    off = torch.einsum("bsfl,fld->bsfd", h.to(x.dtype), p["dd_w2"])
    return x[:, :, None] + xx[:, :, None] * (p["mu"][None, None] + off)


def _decay(p: Params, xw) -> torch.Tensor:
    """Data-dependent per-channel log-decay w < 0, fp32: (B,S,d)."""
    dd = torch.tanh(matmul(xw, p["wd1"]).float()) @ p["wd2"].float()
    return -torch.exp(p["w0"] + dd)


def _group_norm(x, w, b, H: int, eps: float) -> torch.Tensor:
    """Per-head layer norm of x (B,S,d) fp32."""
    B, S, d = x.shape
    xh = x.reshape(B, S, H, d // H)
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, unbiased=False, keepdim=True)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return xh.reshape(B, S, d) * w + b


def time_mix(cfg: ModelConfig, p: Params, x, adapters=None, state=None,
             use_kernel: bool = False):
    """x: (B,S,d).  ``state``: None (full sequence) or one layer's decode
    state ``{"tm_x", "wkv", ...}`` (then S = 1).  Returns (out (B,S,d), new
    state ``{"tm_x", "wkv"}`` or None)."""
    B, S, d = x.shape
    H, hd = cfg.num_rwkv_heads, cfg.rwkv_head_dim
    a = adapters or {}
    last = state["tm_x"] if state is not None else None
    xx = _shift(x, last) - x
    xr, xk, xv, xw, xg = _ddlerp(p, x, xx).unbind(2)
    r = lora_proj(xr, p["wr"], a.get("wr"), use_kernel).reshape(B, S, H, hd)
    k = lora_proj(xk, p["wk"], a.get("wk"), use_kernel).reshape(B, S, H, hd)
    v = lora_proj(xv, p["wv"], a.get("wv"), use_kernel).reshape(B, S, H, hd)
    g = F.silu(lora_proj(xg, p["wg"], a.get("wg"), use_kernel).float())
    w = _decay(p, xw).reshape(B, S, H, hd)

    if state is not None:                      # O(1) decode update
        s = state["wkv"]                                    # (B,H,hd,hd) fp32
        rt, kt, vt = (t[:, 0].float() for t in (r, k, v))
        kv = kt[..., :, None] * vt[..., None, :]
        y = torch.einsum("bhk,bhkv->bhv", rt, s + p["u"][..., None] * kv)[:, None]
        new_state = {"tm_x": x[:, -1],
                     "wkv": torch.exp(w[:, 0])[..., None] * s + kv}
    elif use_kernel:
        y = kops.wkv6(r, k, v, w, p["u"])
        new_state = None
    else:
        y, _ = wkv_scan(r, k, v, w, p["u"])
        new_state = None

    y = _group_norm(y.reshape(B, -1, d), p["ln_x_w"].float(),
                    p["ln_x_b"].float(), H, cfg.norm_eps)
    y = (y * g).to(x.dtype)
    return lora_proj(y, p["wo"], a.get("wo"), use_kernel), new_state


def channel_mix(cfg: ModelConfig, p: Params, x, adapters=None, state=None,
                use_kernel: bool = False):
    """Squared-ReLU channel mix with a sigmoid receptance gate.  Returns
    (out (B,S,d), ``{"cm_x"}`` or None)."""
    a = adapters or {}
    last = state["cm_x"] if state is not None else None
    xx = _shift(x, last) - x
    xk = x + xx * p["mu_ck"]
    xr = x + xx * p["mu_cr"]
    k = lora_proj(xk, p["wck"], a.get("wck"), use_kernel)
    k = torch.square(F.relu(k.float())).to(x.dtype)
    rgate = torch.sigmoid(lora_proj(xr, p["wcr"], a.get("wcr"), use_kernel).float())
    out = (rgate * lora_proj(k, p["wcv"], a.get("wcv"), use_kernel).float()
           ).to(x.dtype)
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
