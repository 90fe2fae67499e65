"""Mamba2 (SSD) layer (port of ``repro.models.ssm``): the backbone of the
Zamba2 hybrid.

The full-sequence path (train, eval, prefill) is the chunkwise-parallel
SSD algorithm: products within a chunk and a scan of chunk states across
chunks; decode is the O(1) single-token recurrence over a carried state.
``n_groups`` = 1 (B and C shared across heads), as in Zamba2-1.2B.  The
reference has no Pallas kernel here: all of it is plain tensor code, and
so it stays in the port.  ``use_kernel`` sends the two projections
(``in_proj``, ``out_proj``) through ``lora_matmul``, as the attention
layers' projections go; paged multi-tenant adapters go through ``bgmv``
(``lora_proj``).

Parameters are stacked ``(L, ...)`` dicts under the reference's keys, with
``A_log``, ``D`` and ``dt_bias`` in fp32 beside weights in the model dtype.
The decode state keeps the reference's dtypes (``conv`` and ``ssm``
fp32), and decode promotes as the reference's jnp code does: the fp32
conv history joined with a bf16 ``xBC`` makes the causal conv run in fp32,
cast back to the model dtype only after the SiLU.

Memory: the intra-chunk tensors are (B, nc, H, c, c) in fp32, 134 MB each
at B 4, S 512, H 64 and c 256.  They are built head-major, so the product
with the inputs is one batched matmul and the (…, c, c, H, hd) product is
never made, and when autograd records the call they are rebuilt in the
backward pass (:func:`torch.utils.checkpoint.checkpoint`) instead of being
kept across the layers: the layer keeps only its (B, nc, H, c, hd) inputs.

The full-sequence path takes ``tp``, a train mesh, and runs on the
rank's heads in the same layout (:func:`mamba2_fwd`).

Decode takes ``tp``, a serve mesh's ``model`` axis
(:class:`repro_torch.topology.serve.ModelParallel`), and runs head
parallel on the rank's H/m SSM heads.  ``in_proj``'s output fuses ``z |
x | B | C | dt``, so the engine cuts it segment by segment, not
contiguously: the rank's heads' columns of z, x and dt, and B and C whole
(``n_groups`` = 1: every head reads them); ``conv_w``, ``conv_b`` and the
conv state follow that cut of ``x | B | C``.  The rank's ``A_log``, ``D``,
``dt_bias`` and norm weight are cut from the replicated leaves.  The gated
RMSNorm runs over the whole ``d_inner``: one fp32 ``all_reduce`` of the
rows' partial sums of squares, then the rank's channels scale; ``out_proj``
is row-parallel with one ``all_reduce``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.models.layers import _proj, dense_init, rmsnorm
from repro_torch.peft.lora import COL, ROW, lora_proj
from repro_torch.topology.partitioning import mamba_segments

Params = Dict[str, Any]

CHUNK = 256


def init_mamba2(cfg: ModelConfig, generator: torch.Generator, L: int,
                dtype: torch.dtype) -> Params:
    """Stacked ``(L, ...)`` weights of ``L`` Mamba2 mixers with the
    reference's distributions; ``A_log``, ``D`` and ``dt_bias`` in fp32."""
    d, din, st, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.num_ssm_heads
    dev = generator.device
    proj_out = 2 * din + 2 * st + H
    conv_w = torch.randn((L, cfg.ssm_conv, din + 2 * st), generator=generator,
                         device=dev) * 0.1
    a_log = torch.log(torch.linspace(1.0, 16.0, H, device=dev))
    return {
        "in_proj": dense_init(generator, (L, d, proj_out), d, dtype),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((L, din + 2 * st), dtype=dtype, device=dev),
        "A_log": a_log.expand(L, H).clone(),
        "D": torch.ones((L, H), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((L, H), dtype=torch.float32, device=dev),
        "norm": torch.ones((L, din), dtype=dtype, device=dev),
        "out_proj": dense_init(generator, (L, din, d), din, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, x (B,S,C), w (K,C), summed in x's dtype tap
    by tap as the reference does; the SiLU in fp32."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, :S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i: i + S] * w[i]
    return F.silu((out + b).float()).to(x.dtype)


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor, din: int = 0):
    """(z, xBC, dt) of the joint input projection (``din``: the rank's
    share of ``d_inner`` under tensor parallelism)."""
    din, st = din or cfg.d_inner, cfg.ssm_state
    return (zxbcdt[..., :din], zxbcdt[..., din: 2 * din + 2 * st],
            zxbcdt[..., 2 * din + 2 * st:])


def _gate_out(cfg: ModelConfig, p: Params, y, z, dtype, adapters,
              use_kernel: bool, tp=None):
    """The gated RMSNorm and ``out_proj`` of the SSD output y (fp32); under
    ``tp`` the norm's mean square sums every rank's channels (under a
    train mesh through ``reduce`` and then ``copy``: each rank's gradient
    of the sum is the part its channels take, and the backward adds the
    parts), and ``out_proj`` is row-parallel."""
    y = y.to(dtype)
    g = y * F.silu(z.float()).to(dtype)
    if tp is None:
        y = rmsnorm(g, p["norm"], cfg.norm_eps)
    else:
        gf = g.float()
        var = tp.copy(tp.reduce(gf.square().sum(-1, keepdim=True))) / cfg.d_inner
        y = (gf * torch.rsqrt(var + cfg.norm_eps)
             * tp.local(p["norm"]).float()).to(dtype)
    out = _proj(y, p["out_proj"], adapters.get("out_proj"), use_kernel, tp, ROW)
    return out if tp is None else tp.reduce(out)


def mamba2_fwd(cfg: ModelConfig, p: Params, x: torch.Tensor, adapters=None,
               use_kernel: bool = False, tp=None) -> torch.Tensor:
    """One Mamba2 mixer over a full sequence, x (B,S,d) -> (B,S,d).

    ``tp``: a train mesh (:class:`repro_torch.topology.train.
    TrainParallel`), ``p`` the rank's shards (``in_proj``, ``conv_w`` and
    ``conv_b`` cut segment by segment,
    :func:`repro_torch.topology.partitioning.mamba_segments`): x enters
    through one ``copy``, ``in_proj`` gives the rank's heads' z, x and dt
    and the whole B and C (its adapter's B cut by the same segments), the
    conv and the chunked SSD run on the rank's H/m heads, and the gated
    norm and ``out_proj`` are :func:`_gate_out`'s.  B and C are whole on
    every rank but feed only its heads, so each rank's gradient of them
    is a part: the ``copy`` adds the parts once, and the packed gradient
    sum adds the adapter's."""
    Bsz, S, _ = x.shape
    din, st, H, hd = cfg.d_inner, cfg.ssm_state, cfg.num_ssm_heads, cfg.ssm_head_dim
    a_log, d_skip, dt_bias = p["A_log"], p["D"], p["dt_bias"]
    a = adapters or {}
    if tp is not None:
        din, H = din // tp.size, H // tp.size
        a_log, d_skip, dt_bias = (tp.local(t) for t in (a_log, d_skip, dt_bias))
        zxbcdt = _proj(tp.copy(x), p["in_proj"], a.get("in_proj"), use_kernel,
                       tp, COL, mamba_segments(cfg)[0])
    else:
        zxbcdt = lora_proj(x, p["in_proj"], a.get("in_proj"), use_kernel)
    z, xBC, dt = _split_proj(cfg, zxbcdt, din)
    xBC = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    xs = xBC[..., :din].reshape(Bsz, S, H, hd)
    Bm, Cm = xBC[..., din: din + st], xBC[..., din + st:]
    dt = F.softplus(dt.float() + dt_bias)                      # (B,S,H)
    dA = dt * -torch.exp(a_log)
    y = _ssd_chunked(xs, dt, dA, Bm, Cm)
    y = y + d_skip[None, None, :, None] * xs.float()
    return _gate_out(cfg, p, y.reshape(Bsz, S, din), z, x.dtype, a, use_kernel,
                     tp)


def _intra_chunk(cum_h: torch.Tensor, scores: torch.Tensor,
                 u: torch.Tensor) -> torch.Tensor:
    """y[t] = sum_{s<=t} exp(cum_t - cum_s) (C_t . B_s) u_s within each
    chunk.  cum_h (B,nc,H,c), scores (B,nc,t,s), u = dt·x (B,nc,H,c,hd);
    returns (B,nc,H,c,hd)."""
    c = cum_h.shape[-1]
    tri = torch.ones((c, c), dtype=torch.bool, device=cum_h.device).tril()
    seg = cum_h[..., :, None] - cum_h[..., None, :]        # (B,nc,H,t,s)
    # mask BEFORE exp: masked (s>t) entries have seg>0 and can overflow, and
    # a where() after exp alone turns 0·inf into NaN in the backward pass
    seg = torch.where(tri, seg, 0.0)
    decay = torch.where(tri, torch.exp(seg), 0.0)
    return (scores[:, :, None] * decay) @ u


def _ssd_chunked(xs, dt, dA, Bm, Cm, chunk: int = CHUNK) -> torch.Tensor:
    """Chunkwise-parallel SSD.  xs (B,S,H,hd), dt and dA (B,S,H) fp32, Bm
    and Cm (B,S,st).  Returns fp32 (B,S,H,hd).  ``S`` must be a multiple
    of ``min(chunk, S)``."""
    Bsz, S, H, hd = xs.shape
    st = Bm.shape[-1]
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"SSD chunks of {c} do not tile a sequence of {S}")
    nc = S // c
    xf = xs.float().reshape(Bsz, nc, c, H, hd)
    dt_, dA_ = dt.reshape(Bsz, nc, c, H), dA.reshape(Bsz, nc, c, H)
    B_ = Bm.float().reshape(Bsz, nc, c, st)
    C_ = Cm.float().reshape(Bsz, nc, c, st)

    cum = torch.cumsum(dA_, dim=2)                          # (B,nc,c,H)
    scores = C_ @ B_.mT                                     # (B,nc,t,s)
    u = (dt_[..., None] * xf).transpose(2, 3)               # (B,nc,H,c,hd)
    cum_h = cum.transpose(2, 3)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (cum_h, scores, u)):
        y_intra = checkpoint(_intra_chunk, cum_h, scores, u, use_reentrant=False)
    else:
        y_intra = _intra_chunk(cum_h, scores, u)

    # chunk-final states and the inter-chunk scan
    dec_end = torch.exp(cum[:, :, -1:, :] - cum)            # (B,nc,c,H)
    states = torch.einsum("bnsk,bnshd->bnhkd", B_,
                          (dec_end * dt_)[..., None] * xf)  # (B,nc,H,st,hd)
    total = torch.exp(cum[:, :, -1, :])                     # (B,nc,H)
    h = torch.zeros((Bsz, H, st, hd), dtype=torch.float32, device=xs.device)
    h_prev = []
    for n in range(nc):                                     # emit the previous state
        h_prev.append(h)
        h = h * total[:, n, :, None, None] + states[:, n]
    h_prev = torch.stack(h_prev, dim=1)                     # (B,nc,H,st,hd)
    y_inter = (torch.einsum("bntk,bnhkd->bnthd", C_, h_prev)
               * torch.exp(cum)[..., None])
    return (y_intra.transpose(2, 3) + y_inter).reshape(Bsz, S, H, hd)


# -- decode (single token, O(1) state) ----------------------------------------

def mamba2_init_state(cfg: ModelConfig, batch: int, device) -> Dict:
    """One layer's zero decode state: ``conv`` (B, K-1, d_inner + 2·st) and
    ``ssm`` (B, H, st, hd), both fp32."""
    din, st = cfg.d_inner, cfg.ssm_state
    H, hd = cfg.num_ssm_heads, cfg.ssm_head_dim
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, din + 2 * st),
                            dtype=torch.float32, device=device),
        "ssm": torch.zeros((batch, H, st, hd), dtype=torch.float32,
                           device=device),
    }


def mamba2_decode(cfg: ModelConfig, p: Params, x: torch.Tensor, state: Dict,
                  adapters=None, tp=None):
    """One token, x (B,1,d).  Returns (y (B,1,d), new state); the state
    passed in is not written.  ``tp``: head parallel on the rank's
    segment-cut shards (the module docstring)."""
    Bsz = x.shape[0]
    din, st, H, hd = cfg.d_inner, cfg.ssm_state, cfg.num_ssm_heads, cfg.ssm_head_dim
    a_log, d_skip, dt_bias = p["A_log"], p["D"], p["dt_bias"]
    if tp is not None:
        din, H = din // tp.size, H // tp.size
        a_log, d_skip, dt_bias = (tp.local(t) for t in (a_log, d_skip, dt_bias))
    a = adapters or {}
    zxbcdt = lora_proj(x, p["in_proj"], a.get("in_proj"))
    z, xBC, dt = _split_proj(cfg, zxbcdt, din)
    cdt = torch.promote_types(state["conv"].dtype, xBC.dtype)
    hist = torch.cat([state["conv"].to(cdt), xBC.to(cdt)], dim=1)   # (B,K,cdim)
    w = p["conv_w"]
    wdt = torch.promote_types(cdt, w.dtype)
    conv_out = torch.einsum("bkc,kc->bc", hist.to(wdt), w.to(wdt)) + p["conv_b"]
    xBC = F.silu(conv_out.float()).to(x.dtype)
    xs = xBC[:, :din].reshape(Bsz, H, hd).float()
    Bm, Cm = xBC[:, din: din + st].float(), xBC[:, din + st:].float()
    dt = F.softplus(dt[:, 0].float() + dt_bias)                      # (B,H)
    dec = torch.exp(dt * -torch.exp(a_log))
    h = (state["ssm"] * dec[..., None, None]
         + dt[:, :, None, None] * Bm[:, None, :, None] * xs[:, :, None, :])
    y = torch.einsum("bk,bhkd->bhd", Cm, h) + d_skip[None, :, None] * xs
    out = _gate_out(cfg, p, y.reshape(Bsz, 1, din), z, x.dtype, a, False, tp)
    return out, {"conv": hist[:, 1:], "ssm": h}
