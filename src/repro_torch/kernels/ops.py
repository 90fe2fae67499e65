"""Public kernel wrappers, with the signatures of ``repro.kernels.ops``.

A CUDA tensor launches the hand-written kernel (or the launch raises); a
CPU tensor takes the plain PyTorch version in :mod:`repro_torch.kernels.ref`.
There is no fallback from one to the other.  Each wrapper counts its kernel
launches in a plain integer attribute (``ring_decode.launches``,
``bgmv.launches``, ...), so a run can show that its path went through the
kernels.  A CUDA graph replays its launches without calling a wrapper, so
a capture records the counts its Python calls added (:func:`launch_delta`;
the capture itself launches nothing) and takes them back, and every replay
adds them (:func:`add_launches`).  The wrappers drop the reference's
block-size arguments (``bk``,
``bm``/``bn``, ``bq``/``bk``): those are tuning knobs of the TPU kernels,
and the CUDA kernels' tiles are fixed in their sources.

``lora_matmul`` and ``flash_attention`` are differentiable
(``torch.autograd.Function``).  Their TPU kernels have no backward kernel;
the backward passes are the reference's own: the reference math of
``ops.py``'s custom VJP for ``lora_matmul``, per client (in torch
matmuls, on either device), and a recompute through ``flash_torch`` for
``flash_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.adapter_gram import adapter_gram_cuda
from repro_torch.kernels.adapter_gram import operand as gram_operand
from repro_torch.kernels.bgmv import bgmv_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.lora_matmul import lora_matmul_cuda
from repro_torch.kernels.mla_ring_decode import mla_ring_decode_cuda
from repro_torch.kernels.ring_decode import ring_decode_cuda
from repro_torch.kernels.wkv6 import wkv6_cuda
from repro_torch.models.attention_core import flash_torch


def ring_decode(q, k, v, pos, length, n_tokens=None, window: int = 0,
                k_scale=None, v_scale=None):
    """Flash-decoding over a GQA ring cache.

    q: (B,C,H,hd); k/v: (B,cap,K,hd) raw cache storage (int8 with per-token
    (B,cap,K,1) scales dequantized in-kernel); pos/length/n_tokens: (B,)
    ring state AFTER the chunk write.  Returns (B,C,H,hd) fp32, defined on
    valid query positions ``t < n_tokens[b]``.
    """
    B, C = q.shape[:2]
    if n_tokens is None:
        n_tokens = torch.full((B,), C, dtype=torch.int32, device=q.device)
    if q.device.type == "cpu":
        return ref.ring_decode_ref(q, k, v, pos, length, n_tokens,
                                   window=window, k_scale=k_scale,
                                   v_scale=v_scale)
    out = ring_decode_cuda(q, k, v, pos, length, n_tokens, window,
                           k_scale=k_scale, v_scale=v_scale)
    ring_decode.launches += 1
    return out


ring_decode.launches = 0


def mla_ring_decode(q_eff, c_kv, k_rope, pos, length, n_tokens=None, *,
                    scale: float, window: int = 0,
                    c_kv_scale=None, k_rope_scale=None):
    """Flash-decoding over the MLA compressed-latent ring cache.

    q_eff: (B,C,H,kvr+rope) absorbed queries (taken in fp32); c_kv/k_rope:
    (B,cap,·) raw cache storage (int8 with per-half (B,cap,1) scales fused
    in-kernel); ``scale`` is REQUIRED and must be the un-absorbed
    1/√(nope+rope).  Returns out_lat (B,C,H,kvr) fp32, defined on valid
    query positions ``t < n_tokens[b]``.
    """
    B, C = q_eff.shape[:2]
    if n_tokens is None:
        n_tokens = torch.full((B,), C, dtype=torch.int32, device=q_eff.device)
    kw = dict(c_kv_scale=c_kv_scale, k_rope_scale=k_rope_scale)
    if q_eff.device.type == "cpu":
        return ref.mla_ring_decode_ref(q_eff, c_kv, k_rope, pos, length,
                                       n_tokens, scale, window, **kw)
    out, kernels = mla_ring_decode_cuda(q_eff.float(), c_kv, k_rope, pos,
                                        length, n_tokens, scale, window, **kw)
    mla_ring_decode.launches += kernels     # route "mma" may add its merge
    return out


mla_ring_decode.launches = 0


def bgmv(x, a_pages, b_pages, table, rank, scale, ids):
    """Batched-gather multi-tenant LoRA delta: per row
    ``y_b = scale_b · B_b(A_b x_b)`` at the row's own rank.

    x: (B,C,din); a_pages: (P,pr,din); b_pages: (P,dout,pr); table:
    (maxA,Pmax); rank/scale: (maxA,); ids: (B,) (0 = base, exact zero).
    Returns (B,C,dout) fp32.  Inference only.
    """
    if x.device.type == "cpu":
        return ref.bgmv_ref(x, a_pages, b_pages, table, rank, scale, ids)
    out = bgmv_cuda(x, a_pages, b_pages, table, rank, scale, ids)
    bgmv.launches += 1
    return out


bgmv.launches = 0

def lora_operands(x, w, a, b, scale):
    """The kernel's operands at the reference's rounding points
    (``repro.kernels.ops._lora_matmul_fwd``): ``a`` in x's dtype and
    ``(b · scale)`` rounded to w's dtype, then to x's."""
    b_scaled = (b * scale).to(w.dtype).to(x.dtype)
    return a.to(x.dtype).contiguous(), b_scaled.contiguous()


class _LoraMatmul(torch.autograd.Function):
    """The client-axis form: x (C, m, din), a (C, r, din), b (C, dout, r),
    scale (C,), w (din, dout) shared and frozen (no gradient).  One kernel
    launch for the cohort (a per-client loop of the plain version for a
    CPU tensor); the backward is the reference's math of ``ops.py``'s
    custom VJP per client, so dA, dB and ds of client c sum over client
    c's rows only."""

    @staticmethod
    def forward(ctx, x, w, a, b, scale):
        a_c, b_s = lora_operands(x, w, a, b, scale[:, None, None])
        if x.device.type == "cpu":
            y = ref.lora_matmul_cohort_ref(x, w, a_c, b_s, 1.0)
        else:
            y = lora_matmul_cuda(x.contiguous(), w.contiguous(), a_c, b_s)
            lora_matmul.launches += 1
        ctx.save_for_backward(x, w, a, b, scale)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, a, b, scale = ctx.saved_tensors
        dt = x.dtype
        sc = scale.to(dt)[:, None, None]
        g = g.to(dt)
        z = x @ a.mT.to(dt)                               # (C, m, r) recomputed
        gz = (g @ b.to(dt)) * sc                          # (C, m, r)
        dx = da = db = ds = None
        if ctx.needs_input_grad[0]:
            dx = g @ w.t() + gz @ a.to(dt)
        if ctx.needs_input_grad[2]:
            da = (gz.mT @ x).to(a.dtype)
        if ctx.needs_input_grad[3]:
            db = ((g.mT @ z) * sc).to(b.dtype)
        if ctx.needs_input_grad[4]:
            ds = torch.sum(g * (z @ b.mT.to(dt)), dim=(1, 2)).to(scale.dtype)
        return dx, None, da, db, ds


def lora_matmul(x, w, a, b, scale):
    """x: (..., din) -> (..., dout), the fused base + adapter projection
    ``x w + scale · (x aᵀ) bᵀ``; differentiable in x, a, b and scale.

    A cohort leaf (a (C, r, din), b (C, dout, r), scale (C,): one adapter
    per client) takes x whose leading rows are the C clients' rows in
    order, x.reshape(C, -1, din), and runs the whole cohort as one launch
    (the reference's ``jax.vmap`` over clients); a single adapter is a
    cohort of one."""
    din = x.shape[-1]
    if a.dim() == 2:
        a, b = a[None], b[None]
    C = a.shape[0]
    y = _LoraMatmul.apply(x.reshape(C, -1, din), w, a, b, scale.reshape(C))
    return y.reshape(*x.shape[:-1], w.shape[1])


lora_matmul.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Kernel forward (or the plain version for a CPU tensor); the backward
    recomputes through ``flash_torch`` with the reference's chunks (512
    query rows and 1024 keys where they divide, one chunk otherwise)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if q.device.type == "cpu":
            o = ref.flash_attention_ref(q, k, v, causal, window).to(q.dtype)
        else:
            o = flash_attention_cuda(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal, window)
            flash_attention.launches += 1
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        S, T = q.shape[1], k.shape[1]
        qc = 512 if S % 512 == 0 else S
        kc = 1024 if T % 1024 == 0 else T
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o = flash_torch(*qkv, causal=ctx.causal, window=ctx.window,
                            q_chunk=qc, kv_chunk=kc).to(q.dtype)
            dq, dk, dv = torch.autograd.grad(o, qkv, g)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """GQA flash attention.  q: (B,S,H,hd), k/v: (B,T,K,hd); any S and T
    (the kernel masks the ragged tiles).  Returns (B,S,H,hd) in q's dtype;
    differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, bool(causal), int(window))


flash_attention.launches = 0


def adapter_gram(x):
    """``xᵀx`` in fp32 for x (m, r), or per batch entry for x (G, m, r) in
    one launch; rows past m are masked in the kernel.  A transposed view
    of a contiguous wide stack (``a.mT`` of a (G, r, n) tensor) is read
    where it lies, without a copy (``adapter_gram.operand``)."""
    if x.device.type == "cpu":
        return ref.adapter_gram_ref(x)
    stored, layout = gram_operand((x if x.dim() == 3 else x[None]).float())
    out = adapter_gram_cuda(stored, layout)
    adapter_gram.launches += 1
    return out if x.dim() == 3 else out[0]


adapter_gram.launches = 0


def wkv6(r, k, v, w, u, chunk: int = 256):
    """RWKV6 WKV recurrence over a whole sequence from a zero state.

    r, k, v: (B,S,H,hd); w: (B,S,H,hd) log-decay; u: (H,hd).  Returns y
    (B,S,H,hd) fp32.  ``chunk`` is the reference's block of tokens: as
    there, ``S % min(chunk, S)`` must be 0 (``ValueError`` otherwise); the
    kernel runs the whole sequence in one launch, so it has no effect on
    the result.  There is no backward, as in the reference: with grad mode
    on and an input that requires grad this raises ``NotImplementedError``
    (RWKV6 trains through ``repro_torch.models.rwkv.wkv_scan``).  r, k and
    v are read as bf16 when all three are bf16, else as fp32.
    """
    S = r.shape[1]
    c = min(chunk, S)
    if c < 1 or S % c:
        raise ValueError(f"wkv6: sequence length {S} is not a multiple of "
                         f"min(chunk, S) = {c}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w, u)):
        raise NotImplementedError(
            "wkv6 has no backward (the reference's kernel has none): "
            "differentiate through repro_torch.models.rwkv.wkv_scan")
    if r.device.type == "cpu":
        return ref.wkv6_ref(r, k, v, w, u)
    dt = r.dtype if r.dtype == k.dtype == v.dtype == torch.bfloat16 else torch.float32
    out = wkv6_cuda(*(t.to(dt).contiguous() for t in (r, k, v)),
                    w.float().contiguous(), u.float().contiguous())
    wkv6.launches += 1
    return out


wkv6.launches = 0

WRAPPERS = {"ring_decode": ring_decode, "mla_ring_decode": mla_ring_decode,
            "bgmv": bgmv,
            "lora_matmul": lora_matmul, "flash_attention": flash_attention,
            "adapter_gram": adapter_gram, "wkv6": wkv6}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def launch_delta(before: dict, after: dict) -> dict:
    """The launches counted between two :func:`launch_counts` readings,
    kernels that did not launch left out."""
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def add_launches(delta: dict, times: int = 1) -> None:
    """Add ``times`` × ``delta`` to the counters (a graph's replays; a
    negative ``times`` takes a capture's Python calls back)."""
    for name, n in delta.items():
        WRAPPERS[name].launches += times * n
