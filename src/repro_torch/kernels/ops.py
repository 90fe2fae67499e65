"""Public kernel wrappers, with the signatures of ``repro.kernels.ops``.

A CUDA tensor launches the hand-written kernel (or the launch raises); a
CPU tensor takes the plain PyTorch version in :mod:`repro_torch.kernels.ref`.
There is no fallback from one to the other.  Each wrapper counts its kernel
launches in a plain integer attribute (``ring_decode.launches``,
``bgmv.launches``, ...), so a run can show that its path went through the
kernels.  The wrappers drop the reference's block-size arguments (``bk``,
``bm``/``bn``, ``bq``/``bk``): those are tuning knobs of the TPU kernels,
and the CUDA kernels' tiles are fixed in their sources.

``lora_matmul`` and ``flash_attention`` are differentiable
(``torch.autograd.Function``).  Their TPU kernels have no backward kernel;
the backward passes are the reference's own: the reference math of
``ops.py``'s custom VJP for ``lora_matmul`` (in torch matmuls, on either
device), and a recompute through ``flash_torch`` for ``flash_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.adapter_gram import adapter_gram_cuda
from repro_torch.kernels.bgmv import bgmv_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.lora_matmul import lora_matmul_cuda
from repro_torch.kernels.ring_decode import ring_decode_cuda
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
    """Fused forward (the kernel, or its plain version for a CPU tensor);
    the reference's backward math for x, A, B and scale.  W is the frozen
    base and gets no gradient."""

    @staticmethod
    def forward(ctx, x, w, a, b, scale):
        a_c, b_s = lora_operands(x, w, a, b, scale)
        if x.device.type == "cpu":
            y = ref.lora_matmul_ref(x, w, a_c, b_s, 1.0)
        else:
            y = lora_matmul_cuda(x.contiguous(), w.contiguous(), a_c, b_s)
            lora_matmul.launches += 1
        ctx.save_for_backward(x, w, a, b, scale)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, a, b, scale = ctx.saved_tensors
        dt = x.dtype
        sc = scale.to(dt)
        g = g.to(dt)
        z = x @ a.t().to(dt)                              # (M, r) recomputed
        gz = (g @ b.to(dt)) * sc                          # (M, r)
        dx = da = db = ds = None
        if ctx.needs_input_grad[0]:
            dx = g @ w.t() + gz @ a.to(dt)
        if ctx.needs_input_grad[2]:
            da = (gz.t() @ x).to(a.dtype)
        if ctx.needs_input_grad[3]:
            db = ((g.t() @ z) * sc).to(b.dtype)
        if ctx.needs_input_grad[4]:
            ds = torch.sum(g * (z @ b.t().to(dt))).to(scale.dtype)
            ds = ds.reshape(scale.shape)
        return dx, None, da, db, ds


def lora_matmul(x, w, a, b, scale):
    """x: (..., din) -> (..., dout), the fused base + adapter projection
    ``x w + scale · (x aᵀ) bᵀ``; differentiable in x, a, b and scale."""
    din = x.shape[-1]
    y = _LoraMatmul.apply(x.reshape(-1, din), w, a, b, scale)
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
    one launch; the tail panel is masked in the kernel."""
    if x.device.type == "cpu":
        return ref.adapter_gram_ref(x)
    x3 = x.float().contiguous()
    out = adapter_gram_cuda(x3 if x.dim() == 3 else x3[None])
    adapter_gram.launches += 1
    return out if x.dim() == 3 else out[0]


adapter_gram.launches = 0

WRAPPERS = {"ring_decode": ring_decode, "bgmv": bgmv,
            "lora_matmul": lora_matmul, "flash_attention": flash_attention,
            "adapter_gram": adapter_gram}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
