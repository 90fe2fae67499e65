"""Launch of the RWKV6 WKV recurrence CUDA kernel (``csrc/wkv6.cu``), the
Hopper counterpart of ``repro.kernels.wkv6.wkv6_kernel``.

One block per (batch row, head) walks the whole sequence in chunks of
``CHUNK`` tokens, so one call is one launch.  The products of the chunked
form run on the tensor cores; the state stays in the registers of hd/32
consumer warps while hd/16 producer warps prepare the next chunk.  The
kernel is built for head dims 32 (RWKV6's SMOKE config) and 64 (the
published one).

Beside the launch: :func:`plan`, the launch arithmetic the CUDA source
repeats (grid, chunks, shared memory, blocks an SM), and
:func:`wkv6_chunked_plain`, plain PyTorch in the kernel's order (the chunk,
its running-product decays and its one reference point), for the tests.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64)
CHUNK = 16                       # tokens a chunk: the mma's row count
_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PAD = 8                         # row pad (floats) of a [token][channel] tile
_LDP = CHUNK + 4                 # row stride of the score tile
# H100 (sm_90): shared memory an SM holds, and what each block reserves
SM_SHARED_BYTES = 233472
BLOCK_RESERVED_BYTES = 1024
MAX_BLOCK_SHARED_BYTES = 232448
MAX_THREADS_PER_SM = 2048


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"wkv6 kernel: {msg}")


def check_head_dim(hd: int) -> None:
    """Raises ``ValueError`` naming ``HEAD_DIMS`` for a head dim outside it."""
    _check(hd in HEAD_DIMS, f"head dim {hd}; the kernel takes {HEAD_DIMS}")


def raw_stages(hd: int, elem_size: int) -> int:
    """Raw stages of the cp.async ring: three (two chunks in flight) where
    two blocks (hd 64) or four (hd 32) an SM still fit, else two."""
    return 2 if hd == 32 and elem_size == 4 else 3


def smem_bytes(hd: int, elem_size: int) -> int:
    """Shared memory of one block (``sizeof(Smem<hd, T>)`` in the source):
    the raw stages of r, k, v (``elem_size`` bytes) and w (fp32); d = e^w
    of the chunk being derived; two prepared chunks (r̃, k̃ and v split hi /
    lo, the score tile split hi / lo, the chunk's decay)."""
    tile = CHUNK * (hd + _PAD) * 4
    raw = raw_stages(hd, elem_size) * CHUNK * hd * (3 * elem_size + 4)
    pairs = CHUNK * ((2 * hd + 16) + (2 * hd + 8)) * 4      # r̃, k̃ as (hi, lo)
    prep = pairs + 2 * tile + 2 * CHUNK * _LDP * 4 + 4 * hd
    return raw + tile + 2 * prep


@dataclasses.dataclass(frozen=True)
class Plan:
    grid: int                    # blocks: one per (batch row, head)
    threads: int                 # 3·hd: hd/32 consumer warps (32 state
                                 # rows each) and hd/16 producer warps
    chunks: int                  # chunks a sequence, the last one ragged
    smem: int                    # shared memory a block, bytes
    blocks_per_sm: int           # by shared memory and threads
    waves: int                   # of blocks over ``sms`` SMs


def plan(B: int, S: int, H: int, hd: int, dtype: torch.dtype, sms: int = 132) -> Plan:
    """The kernel's launch for r, k, v (B,S,H,hd) of ``dtype``."""
    check_head_dim(hd)
    threads = 3 * hd
    smem = smem_bytes(hd, torch.tensor([], dtype=dtype).element_size())
    per_sm = min(SM_SHARED_BYTES // (smem + BLOCK_RESERVED_BYTES),
                 MAX_THREADS_PER_SM // threads)
    return Plan(grid=B * H, threads=threads, chunks=-(-S // CHUNK), smem=smem,
                blocks_per_sm=per_sm, waves=-(-(B * H) // (per_sm * sms)))


def compiled_smem_bytes(hd: int, dtype: torch.dtype) -> int:
    """The built kernel's own ``sizeof(Smem<hd, T>)`` (needs the CUDA
    build), against which :func:`smem_bytes` is checked on the card."""
    fn = build.load("wkv6").wkv6_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_long
    return int(fn(hd, _CODES[dtype]))


def wkv6_chunked_plain(r, k, v, w, u) -> torch.Tensor:
    """The kernel's arithmetic in plain fp32 PyTorch, for the tests: chunks
    of ``CHUNK`` tokens (the last zero-padded: r = k = v = 0, d = 1), the
    chunk start as the one reference point, every decay a running product
    of d = e^w inside the chunk (never an exp of a difference, never a
    quotient).  Per chunk, with S₀ the state entering it:
    y_t = (r_t ⊙ Π_{j<t} d_j)ᵀ S₀ + Σ_{s<t} P[t,s] v_s + (Σ r_t u k_t) v_t,
    P[t,s] = Σ_k r_t k_s Π_{s<j<t} d_j (key s carries k_s ⊙ Π d forward
    one token at a time), and
    S ← (Π_j d_j) ⊙ S₀ + Σ_s (k_s ⊙ Π_{j>s} d_j) v_sᵀ.
    Shapes as :func:`repro_torch.kernels.ref.wkv6_ref`; returns y fp32."""
    B, S, H, hd = r.shape
    n = -(-S // CHUNK)
    pad = n * CHUNK - S

    def chunks(t):                                   # (B, H, n, C, hd)
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
        return t.reshape(B, n, CHUNK, H, hd).permute(0, 3, 1, 2, 4)

    rc, kc, vc, wc = (chunks(t) for t in (r, k, v, w))
    dc = torch.exp(wc)
    uf = u.float()[None, :, None, :]                 # (1, H, 1, hd)
    state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    ys = []
    for c in range(n):
        rr, kk, vv, dd = rc[:, :, c], kc[:, :, c], vc[:, :, c], dc[:, :, c]
        q = torch.empty_like(rr)                     # r̃: prefix products
        run = torch.ones_like(rr[:, :, 0])
        for t in range(CHUNK):
            q[:, :, t] = rr[:, :, t] * run
            run = run * dd[:, :, t]
        dec = run                                    # Π_j d_j
        kt = torch.empty_like(kk)                    # k̃: suffix products
        run = torch.ones_like(kk[:, :, 0])
        for s in reversed(range(CHUNK)):
            kt[:, :, s] = kk[:, :, s] * run
            run = run * dd[:, :, s]
        # in-chunk scores: key s carries k_s ⊙ Π_{s<j<t} d_j forward
        P = torch.zeros((B, H, CHUNK, CHUNK), dtype=torch.float32, device=r.device)
        kf = kk.clone()
        for t in range(1, CHUNK):
            P[:, :, t, :t] = torch.einsum("bhk,bhsk->bhs", rr[:, :, t], kf[:, :, :t])
            kf[:, :, :t] = kf[:, :, :t] * dd[:, :, t, None]
        idx = torch.arange(CHUNK)
        P[:, :, idx, idx] = (rr * uf * kk).sum(-1)  # the bonus
        ys.append(torch.einsum("bhtk,bhkv->bhtv", q, state)
                  + torch.einsum("bhts,bhsv->bhtv", P, vv))
        state = dec[..., None] * state + torch.einsum("bhsk,bhsv->bhkv", kt, vv)
    y = torch.stack(ys, dim=2).reshape(B, H, n * CHUNK, hd)[:, :, :S]
    return y.permute(0, 2, 1, 3).contiguous()


def wkv6_cuda(r, k, v, w, u) -> torch.Tensor:
    """r, k, v (B,S,H,hd) of one dtype (fp32 or bf16), w (B,S,H,hd) fp32,
    u (H,hd) fp32, all contiguous and 16-byte aligned on one CUDA device,
    hd in ``HEAD_DIMS``.  Returns y (B,S,H,hd) fp32."""
    _check(r.dim() == 4 and r.shape == k.shape == v.shape == w.shape,
           f"shapes r{tuple(r.shape)} k{tuple(k.shape)} v{tuple(v.shape)} "
           f"w{tuple(w.shape)}")
    B, S, H, hd = r.shape
    check_head_dim(hd)
    _check(u.shape == (H, hd), f"u {tuple(u.shape)} for {H} heads of {hd}")
    _check(r.dtype in _CODES and k.dtype == v.dtype == r.dtype,
           f"dtypes r/k/v {r.dtype}/{k.dtype}/{v.dtype}")
    _check(w.dtype == torch.float32 and u.dtype == torch.float32,
           f"w and u must be float32, got {w.dtype} and {u.dtype}")
    dev = r.device
    _check(dev.type == "cuda" and all(t.device == dev for t in (k, v, w, u)),
           "every tensor must be on the same CUDA device")
    _check(all(t.is_contiguous() for t in (r, k, v, w, u)),
           "tensors must be contiguous")
    _check(all(t.data_ptr() % 16 == 0 for t in (r, k, v, w, u)),
           "tensors must start on 16-byte boundaries (cp.async)")
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=dev)
    err = build.load("wkv6").wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), _CODES[r.dtype], w.data_ptr(),
        u.data_ptr(), y.data_ptr(), B, S, H, hd,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: error {err}")
    return y
