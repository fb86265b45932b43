"""Attention ops: the dense plain version, and flash attention as
hand-written CUDA kernels beside their plain blockwise versions.

Counterpart of ``ray_tpu/ops/attention.py``:

- ``attention_xla``: dense einsum softmax attention, the reference math.
- ``flash_attention_ref``, ``flash_bwd_dq_ref`` and ``flash_bwd_dkv_ref``:
  the blockwise arithmetic of the forward (optionally with its per-row
  logsumexp) and of each backward kernel in plain PyTorch (the analog of
  the JAX kernels' ``interpret=True``); ``flash_attention_bwd_ref``
  composes the two backward ones. The CPU tests and ``chip_smoke.py`` hold
  the kernels to them.
- ``flash_attention``: the wrapper, the analog of the JAX ``custom_vjp``,
  over three custom ops that a compiled program traces through (each has
  a fake implementation). Without a gradient to record it runs
  ``ray_tpu_torch::flash_fwd``, which launches K1 (the forward,
  ``csrc/flash_fwd.cu``) on CUDA tensors. With one, the forward is
  ``ray_tpu_torch::flash_fwd_lse``: it launches K2 (the same forward, also
  writing lse) and saves (q, k, v, out, lse), and its backward is
  ``ray_tpu_torch::flash_bwd``, which launches K4 (dQ, and delta =
  rowsum(dO * O)) and then K3 (dK, dV, from that delta), from
  ``csrc/flash_bwd.cu``. CPU tensors, and ``interpret=True`` on any
  device, run the plain versions inside the same ops. There is no fallback
  from a kernel to a plain version.
- ``attention``: the dispatcher.

The three custom ops carry DTensor strategies (the end of this module): on
DTensors sharded on the batch or the heads each runs locally on each
rank's shard. A sequence sharded over the mesh goes through
``parallel/ring_attention.py`` instead, whose pieces are these ops.

Shapes follow [batch, seq, heads, head_dim] throughout; lse is
[batch, heads, seq_q] f32.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from types import SimpleNamespace
from typing import Optional, Tuple, Union

import torch

NEG_INF = -1e30

# The CUDA kernels pick their own tiles (sized for Hopper's shared memory
# and registers). These defaults only set the tiling of the plain blockwise
# versions.
DEFAULT_BLOCK_Q = 64
DEFAULT_BLOCK_K = 64

_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of each kernel in this process; each wrapper adds one where it
# launches its kernel, and nowhere else. A wrapper called while its thread
# captures a CUDA graph launches nothing: it adds to that capture's
# ``recorded`` counts instead, and each replay of the graph, which launches
# what it recorded, adds those (``count_replay``).
launches = {"flash_fwd": 0, "flash_fwd_lse": 0, "flash_bwd_dkv": 0,
            "flash_bwd_dq": 0}
_capturing = threading.local()


@contextlib.contextmanager
def recorded():
    """Around a CUDA graph capture on this thread: yields the dict of the
    kernels' launches that the capture records."""
    counts = _capturing.counts = dict.fromkeys(launches, 0)
    try:
        yield counts
    finally:
        _capturing.counts = None


def count_replay(counts) -> None:
    """A replay of a graph whose capture recorded ``counts``."""
    for name, n in counts.items():
        launches[name] += n


def _count(name: str) -> None:
    counts = getattr(_capturing, "counts", None)
    (launches if counts is None else counts)[name] += 1


def attention_xla(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    bias: Optional[torch.Tensor] = None,
    q_offset: Union[int, torch.Tensor] = 0,
    kv_offset: Union[int, torch.Tensor] = 0,
) -> torch.Tensor:
    """Dense attention. q: [B, Tq, H, D]; k/v: [B, Tk, Hkv, D].

    Grouped-query attention (H a multiple of Hkv) repeats the kv heads;
    ``q_offset``/``kv_offset`` are absolute positions of the first query and
    key, for callers holding a chunk of the sequence."""
    B, Tq, H, D = q.shape
    _, Tk, Hkv, _ = k.shape
    if Hkv != H:
        rep = H // Hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = D ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    logits = logits.to(torch.float32)
    if bias is not None:
        logits = logits + bias
    if causal:
        q_pos = torch.arange(Tq, device=q.device)[:, None] + q_offset
        k_pos = torch.arange(Tk, device=q.device)[None, :] + kv_offset
        mask = q_pos >= k_pos
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _fold(x: torch.Tensor, T_p: int, H: int) -> torch.Tensor:
    """[B, T, Hx, D] -> [B*H, T_p, D]: kv heads repeated to H, the sequence
    zero-padded to T_p (the JAX kernels' folded layout)."""
    B, T, Hx, D = x.shape
    if Hx != H:
        x = x.repeat_interleave(H // Hx, dim=2)
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, T_p - T))
    return x.permute(0, 2, 1, 3).reshape(B * H, T_p, D)


def _unfold(x: torch.Tensor, B: int, H: int, T: int) -> torch.Tensor:
    """[B*H, T_p, D] -> [B, T, H, D]."""
    return x.reshape(B, H, -1, x.shape[-1]).permute(0, 2, 1, 3)[:, :T]


def flash_attention_ref(q, k, v, causal: bool = True,
                        block_q: int = DEFAULT_BLOCK_Q,
                        block_k: int = DEFAULT_BLOCK_K,
                        with_lse: bool = False):
    """The forward kernels' arithmetic in plain PyTorch, block by block.

    Pads to block multiples and masks keys at or past the true length; per
    query block, streams K/V blocks up to the causal limit with a running
    max m, denominator l and accumulator in f32; products take the input
    dtype's values with f32 accumulation; scores are scaled in f32; P is cast
    to V's dtype before the PV product; out = acc / max(l, 1e-30). With
    ``with_lse`` also returns lse = max(m, NEG_INF) + log(max(l, 1e-30)),
    [B, H, Tq] f32 (JAX's rule, attention.py:134)."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    block_q = min(block_q, Tq)
    block_k = min(block_k, Tk)
    scale = D ** -0.5
    Tq_p = block_q * ((Tq + block_q - 1) // block_q)
    Tk_p = block_k * ((Tk + block_k - 1) // block_k)
    qf, kf, vf = _fold(q, Tq_p, H), _fold(k, Tk_p, H), _fold(v, Tk_p, H)
    out = torch.empty((B * H, Tq_p, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, Tq_p), dtype=torch.float32, device=q.device)
    num_k_blocks = (Tk + block_k - 1) // block_k
    for qi in range(Tq_p // block_q):
        qb = qf[:, qi * block_q:(qi + 1) * block_q].to(torch.float32)
        num_iter = num_k_blocks
        if causal:
            num_iter = min(num_k_blocks, ((qi + 1) * block_q - 1) // block_k + 1)
        acc = torch.zeros((B * H, block_q, D), dtype=torch.float32, device=q.device)
        m = torch.full((B * H, block_q, 1), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B * H, block_q, 1), dtype=torch.float32, device=q.device)
        q_pos = qi * block_q + torch.arange(block_q, device=q.device)[:, None]
        for i in range(num_iter):
            kb = kf[:, i * block_k:(i + 1) * block_k]
            vb = vf[:, i * block_k:(i + 1) * block_k]
            s = torch.matmul(qb, kb.to(torch.float32).transpose(1, 2)) * scale
            k_pos = i * block_k + torch.arange(block_k, device=q.device)[None, :]
            mask = k_pos < Tk
            if causal:
                mask = mask & (q_pos >= k_pos)
            s = s.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(
                p.to(vb.dtype).to(torch.float32), vb.to(torch.float32)
            )
            m = m_new
        rows = slice(qi * block_q, (qi + 1) * block_q)
        out[:, rows] = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
        lse[:, rows] = (torch.clamp(m, min=NEG_INF)
                        + torch.log(torch.clamp(l, min=1e-30)))[..., 0]
    out = _unfold(out, B, H, Tq)
    if with_lse:
        return out, lse.reshape(B, H, Tq_p)[..., :Tq]
    return out


def _bwd_blocks(q, k, v, do, lse, causal: bool, block_q: int, block_k: int):
    """What the backward plain versions share (JAX ``_flash_bwd_impl``,
    attention.py:312-396): block sizes and counts, the folded operands
    ([B*H, T_p, D], kv heads repeated, zero-padded; dO in q's dtype) and
    ``probs(qi, ki, delta)``, the f32 (P, dS) of query block qi against key
    block ki, with delta folded to [B*H, Tq_p].

    P = exp(scale * q.k - lse), forced to 0 for queries at or past Tq, keys
    at or past Tk and keys above the diagonal; dP = dO V^T; dS = P (dP -
    delta) scale. Products take the input dtype's values with f32
    accumulation."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    block_q = min(block_q, Tq)
    block_k = min(block_k, Tk)
    scale = D ** -0.5
    f32 = torch.float32
    Tq_p = block_q * ((Tq + block_q - 1) // block_q)
    Tk_p = block_k * ((Tk + block_k - 1) // block_k)
    qf, kf, vf = _fold(q, Tq_p, H), _fold(k, Tk_p, H), _fold(v, Tk_p, H)
    dof = _fold(do.to(q.dtype), Tq_p, H)
    lsef = torch.nn.functional.pad(lse.to(f32).reshape(B * H, Tq), (0, Tq_p - Tq))
    dev = q.device
    arange_q = torch.arange(block_q, device=dev)
    arange_k = torch.arange(block_k, device=dev)

    def probs(qi, ki, delta):
        rq = slice(qi * block_q, (qi + 1) * block_q)
        rk = slice(ki * block_k, (ki + 1) * block_k)
        s = scale * torch.matmul(qf[:, rq].to(f32), kf[:, rk].to(f32).transpose(1, 2))
        q_pos = qi * block_q + arange_q[:, None]
        k_pos = ki * block_k + arange_k[None, :]
        mask = (q_pos < Tq) & (k_pos < Tk)
        if causal:
            mask = mask & (q_pos >= k_pos)
        p = torch.where(mask, torch.exp(s - lsef[:, rq, None]),
                        torch.zeros((), dtype=f32, device=dev))
        dp = torch.matmul(dof[:, rq].to(f32), vf[:, rk].to(f32).transpose(1, 2))
        ds = p * (dp - delta[:, rq, None]) * scale
        return p, ds

    return SimpleNamespace(block_q=block_q, block_k=block_k, Tq_p=Tq_p,
                           Tk_p=Tk_p, n_q=Tq_p // block_q, n_k=Tk_p // block_k,
                           qf=qf, kf=kf, dof=dof, probs=probs)


def flash_bwd_dq_ref(q, k, v, out, lse, do, causal: bool = True,
                     block_q: int = DEFAULT_BLOCK_Q,
                     block_k: int = DEFAULT_BLOCK_K):
    """K4's arithmetic in plain PyTorch, block by block: (dq, delta).

    delta = rowsum(dO * O) in f32, [B, H, Tq] (torch ops here, as JAX
    computes it in XLA, attention.py:342). dQ: per query block, stream K/V
    blocks up to the causal limit, dQ += dS K with dS cast to the input
    dtype (JAX ``_flash_bwd_dq_kernel``, :265); dq in the input dtype."""
    B, Tq, H, D = q.shape
    f32 = torch.float32
    bw = _bwd_blocks(q, k, v, do, lse, causal, block_q, block_k)
    delta = (bw.dof.to(f32) * _fold(out, bw.Tq_p, H).to(f32)).sum(-1)  # [B*H, Tq_p]
    dq = torch.zeros((B * H, bw.Tq_p, D), dtype=f32, device=q.device)
    for qi in range(bw.n_q):
        n_iter = bw.n_k
        if causal:
            n_iter = min(bw.n_k, ((qi + 1) * bw.block_q - 1) // bw.block_k + 1)
        rq = slice(qi * bw.block_q, (qi + 1) * bw.block_q)
        for ki in range(n_iter):
            rk = slice(ki * bw.block_k, (ki + 1) * bw.block_k)
            _, ds = bw.probs(qi, ki, delta)
            dq[:, rq] += torch.matmul(ds.to(q.dtype).to(f32), bw.kf[:, rk].to(f32))
    return (_unfold(dq, B, H, Tq).to(q.dtype),
            delta.reshape(B, H, bw.Tq_p)[..., :Tq])


def flash_bwd_dkv_ref(q, k, v, delta, lse, do, causal: bool = True,
                      block_q: int = DEFAULT_BLOCK_Q,
                      block_k: int = DEFAULT_BLOCK_K):
    """K3's arithmetic in plain PyTorch, block by block: (dk, dv) from the
    given delta ([B, H, Tq] f32; K4's, or ``flash_bwd_dq_ref``'s).

    Per key block, stream Q/dO blocks from the causal start; dV += P (cast
    to dO's dtype)^T dO, dK += dS (cast to the input dtype)^T Q (JAX
    ``_flash_bwd_dkv_kernel``, :208). dk/dv are summed over each kv head's
    query heads in f32 before the cast to the inputs' dtype, as the kernel
    sums them."""
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    f32 = torch.float32
    bw = _bwd_blocks(q, k, v, do, lse, causal, block_q, block_k)
    deltaf = torch.nn.functional.pad(delta.to(f32).reshape(B * H, Tq),
                                     (0, bw.Tq_p - Tq))
    dk = torch.zeros((B * H, bw.Tk_p, D), dtype=f32, device=q.device)
    dv = torch.zeros((B * H, bw.Tk_p, D), dtype=f32, device=q.device)
    for ki in range(bw.n_k):
        start = (ki * bw.block_k) // bw.block_q if causal else 0
        rk = slice(ki * bw.block_k, (ki + 1) * bw.block_k)
        for qi in range(start, bw.n_q):
            rq = slice(qi * bw.block_q, (qi + 1) * bw.block_q)
            p, ds = bw.probs(qi, ki, deltaf)
            dv[:, rk] += torch.matmul(
                p.to(do.dtype).to(f32).transpose(1, 2), bw.dof[:, rq].to(f32))
            dk[:, rk] += torch.matmul(
                ds.to(q.dtype).to(f32).transpose(1, 2), bw.qf[:, rq].to(f32))
    dk, dv = _unfold(dk, B, H, Tk), _unfold(dv, B, H, Tk)
    if Hkv != H:
        dk = dk.reshape(B, Tk, Hkv, H // Hkv, D).sum(3)
        dv = dv.reshape(B, Tk, Hkv, H // Hkv, D).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_ref(q, k, v, out, lse, do, causal: bool = True,
                            block_q: int = DEFAULT_BLOCK_Q,
                            block_k: int = DEFAULT_BLOCK_K):
    """The backward kernels' arithmetic in plain PyTorch: ``flash_bwd_dq_ref``
    (K4, which also gives delta), then ``flash_bwd_dkv_ref`` (K3) on that
    delta. Returns (dq, dk, dv) in the inputs' dtype, dk/dv summed over each
    kv head's query heads."""
    dq, delta = flash_bwd_dq_ref(q, k, v, out, lse, do, causal, block_q, block_k)
    dk, dv = flash_bwd_dkv_ref(q, k, v, delta, lse, do, causal, block_q, block_k)
    return dq, dk, dv


# ------------------------------------------------------------ CUDA kernels

def _lib(name: str, functions) -> ctypes.CDLL:
    """Kernel library ``name``, built at first use, with ``argtypes`` set for
    each of ``functions`` ({C name: argtypes})."""
    from ray_tpu_torch.ops import _build

    lib = _build.load(name)
    if not getattr(lib, "_rt_typed", False):
        for fn, argtypes in functions.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.rt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rt_cuda_error_string.restype = ctypes.c_char_p
        lib._rt_typed = True
    return lib


_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_TAIL = [_I32, ctypes.c_float, _I32, _P]          # causal, scale, dtype, stream
_FWD_ARGS = {"rt_flash_fwd": [_P] * 5 + [_I32] * 6 + [_I64] * 12 + _TAIL}
_BWD_ARGS = {
    "rt_flash_bwd_dq": [_P] * 8 + [_I32] * 6 + [_I64] * 18 + _TAIL,
    "rt_flash_bwd_dkv": [_P] * 8 + [_I32] * 6 + [_I64] * 15 + _TAIL,
}


def _kernel_ready(x: torch.Tensor) -> torch.Tensor:
    """The kernels read 16 bytes at a time along D from each (b, t, h) row:
    the last dim must be contiguous and every other stride and the base
    address 16-byte aligned. Views that are not get one contiguous copy."""
    ok = (
        x.stride(-1) == 1
        and all(s % 8 == 0 for s in x.stride()[:-1])
        and x.data_ptr() % 16 == 0
    )
    return x if ok else x.contiguous()


def _check_inputs(q, k, v) -> None:
    B, Tq, H, D = q.shape
    Bk, Tk, Hkv, Dk = k.shape
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention kernel takes float32 or bfloat16 q/k/v of one "
            f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if D not in _HEAD_DIMS or Dk != D or v.shape != k.shape or Bk != B:
        raise ValueError(
            f"flash_attention kernel: bad shapes q {tuple(q.shape)} "
            f"k {tuple(k.shape)} v {tuple(v.shape)} (head_dim in {_HEAD_DIMS})"
        )
    if H % Hkv != 0:
        raise ValueError(f"num_heads {H} not a multiple of kv heads {Hkv}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must be on one device")


def _raise_on(lib, rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{kernel} launch failed: "
            + lib.rt_cuda_error_string(rc).decode(errors="replace")
        )


def _strides(*tensors):
    return [s for t in tensors for s in t.stride()[:3]]


def _flash_fwd_cuda(q, k, v, causal: bool, with_lse: bool = False):
    """K1 (``with_lse=False``: returns out) or K2 (returns out and lse)."""
    _check_inputs(q, k, v)
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    q, k, v = _kernel_ready(q), _kernel_ready(k), _kernel_ready(v)
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = _lib("flash_fwd", _FWD_ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.rt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if with_lse else None,
            B, Tq, Tk, H, Hkv, D, *_strides(q, k, v, o),
            int(bool(causal)), float(D ** -0.5), _DTYPE_CODES[q.dtype], stream,
        )
    name = "flash_fwd_lse" if with_lse else "flash_fwd"
    _raise_on(lib, rc, name)
    _count(name)
    return (o, lse) if with_lse else o


def _flash_bwd_launch(kernel: str, pointers, strided, q, k, causal: bool) -> None:
    """Launch ``rt_<kernel>`` on the pointers of ``pointers`` and the [B, T,
    heads, D] strides of ``strided``, in the C interface's order."""
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    lib = _lib("flash_bwd", _BWD_ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, "rt_" + kernel)(
            *(t.data_ptr() for t in pointers), B, Tq, Tk, H, Hkv, D,
            *_strides(*strided), int(bool(causal)), float(D ** -0.5),
            _DTYPE_CODES[q.dtype], stream,
        )
    _raise_on(lib, rc, kernel)
    _count(kernel)


def _flash_bwd_dq_launch(q, k, v, out, do, lse, dq, delta, causal: bool) -> None:
    """K4: dq and delta = rowsum(dO * O) ([B, H, Tq] f32) into preallocated
    contiguous outputs. The inputs are ``_flash_bwd_prepare``'s."""
    _flash_bwd_launch("flash_bwd_dq", (q, k, v, do, out, lse, delta, dq),
                      (q, k, v, do, out, dq), q, k, causal)


def _flash_bwd_dkv_launch(q, k, v, do, lse, delta, dk, dv, causal: bool) -> None:
    """K3: dk and dv into preallocated contiguous outputs, from K4's delta."""
    _flash_bwd_launch("flash_bwd_dkv", (q, k, v, do, lse, delta, dk, dv),
                      (q, k, v, do, dk), q, k, causal)


def _flash_bwd_prepare(q, k, v, out, lse, do):
    """Kernel-ready (q, k, v, out, do), all in q's dtype, and lse
    ([B, H, Tq] f32, contiguous)."""
    _check_inputs(q, k, v)
    B, Tq, H, _ = q.shape
    if out.shape != q.shape or lse.shape != (B, H, Tq) or do.shape != q.shape:
        raise ValueError(f"flash backward: out {tuple(out.shape)} / lse "
                         f"{tuple(lse.shape)} / do {tuple(do.shape)} do not "
                         f"match q {tuple(q.shape)}")
    q, k, v = _kernel_ready(q), _kernel_ready(k), _kernel_ready(v)
    out, do = _kernel_ready(out.to(q.dtype)), _kernel_ready(do.to(q.dtype))
    return q, k, v, out, do, lse.to(torch.float32).contiguous()


def _flash_bwd_cuda(q, k, v, out, lse, do, causal: bool):
    """K4, which also writes delta = rowsum(dO * O), then K3, which reads
    it: (dq, dk, dv, delta)."""
    q, k, v, out, do, lse = _flash_bwd_prepare(q, k, v, out, lse, do)
    B, Tq, H, _ = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _flash_bwd_dq_launch(q, k, v, out, do, lse, dq, delta, causal)
    _flash_bwd_dkv_launch(q, k, v, do, lse, delta, dk, dv, causal)
    return dq, dk, dv, delta


# ------------------------------------------------------ the custom ops

# K1, K2 and the K4+K3 backward are custom ops with fake implementations,
# so that a compiled program (``torch.compile``, the analog of ``jax.jit``;
# ``train/step.py``) traces through them: Dynamo and AOTAutograd take their
# outputs' shapes from the fake implementations and keep each op in the
# graph as one opaque call, which launches its kernel at run time. Each op's
# real implementation is the only place that launches its kernel (and
# counts it), and the place that decides by the tensors' device: a CUDA
# tensor launches the kernel, a CPU tensor (or ``interpret``) runs the plain
# version, so a graph traced on the CPU holds the same ops as the card's.
# Outputs are contiguous on both paths, as the fake implementations say.
# flash_fwd_lse is also what selective activation checkpointing sees by name
# (models/common.py, remat_policy "dots") to keep its outputs, the analog of
# checkpoint_name("flash_out"/"flash_lse") (attention.py:424-425).

@torch.library.custom_op("ray_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, block_q: int, block_k: int,
              interpret: bool) -> torch.Tensor:
    """out: K1 for CUDA tensors, the plain version for CPU tensors or with
    ``interpret``."""
    if interpret or not q.is_cuda:
        return flash_attention_ref(q, k, v, causal, block_q,
                                   block_k).contiguous()
    return _flash_fwd_cuda(q, k, v, causal)


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, causal, block_q, block_k, interpret):
    return q.new_empty(q.shape)


@torch.library.custom_op("ray_tpu_torch::flash_fwd_lse", mutates_args=())
def flash_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, block_q: int, block_k: int,
                  interpret: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): K2 for CUDA tensors, the plain version for CPU tensors or
    with ``interpret``."""
    if interpret or not q.is_cuda:
        out, lse = flash_attention_ref(q, k, v, causal, block_q, block_k,
                                       with_lse=True)
        return out.contiguous(), lse.contiguous()
    return _flash_fwd_cuda(q, k, v, causal, with_lse=True)


@flash_fwd_lse.register_fake
def _flash_fwd_lse_fake(q, k, v, causal, block_q, block_k, interpret):
    B, Tq, H, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((B, H, Tq), dtype=torch.float32)


@torch.library.custom_op("ray_tpu_torch::flash_bwd", mutates_args=())
def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              causal: bool, block_q: int, block_k: int, interpret: bool
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): K4 (which also writes delta = rowsum(dO * O)) then K3
    for CUDA tensors, the plain versions for CPU tensors or with
    ``interpret``."""
    if interpret or not q.is_cuda:
        return tuple(g.contiguous() for g in flash_attention_bwd_ref(
            q, k, v, out, lse, do, causal, block_q, block_k))
    return _flash_bwd_cuda(q, k, v, out, lse, do, causal)[:3]


@flash_bwd.register_fake
def _flash_bwd_fake(q, k, v, out, lse, do, causal, block_q, block_k,
                    interpret):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _setup_context(ctx, inputs, output):
    q, k, v, ctx.causal, ctx.block_q, ctx.block_k, ctx.interpret = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)


def _backward(ctx, d_out, _d_lse):
    q, k, v, out, lse = ctx.saved_tensors
    grads = flash_bwd(q, k, v, out, lse, d_out, ctx.causal, ctx.block_q,
                      ctx.block_k, ctx.interpret)
    return (*grads, None, None, None, None)


flash_fwd_lse.register_autograd(_backward, setup_context=_setup_context)


def flash_attention(q, k, v, causal: bool = True,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K,
                    interpret: bool = False) -> torch.Tensor:
    """Flash attention. q: [B, Tq, H, D]; k/v: [B, Tk, Hkv, D].

    With a gradient to record (grad enabled and q, k or v requiring one),
    runs ``flash_fwd_lse`` (K2 forward, ``flash_bwd`` backward); otherwise
    ``flash_fwd`` (K1). CUDA tensors launch the kernels; CPU tensors, and
    ``interpret=True`` on any device, run the plain versions, forward and
    backward. On CUDA ``block_q``/``block_k`` are unused: the kernels have
    their own tiles. A build or launch error propagates."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out, _ = flash_fwd_lse(q, k, v, causal, block_q, block_k, interpret)
        return out
    return flash_fwd(q, k, v, causal, block_q, block_k, interpret)


def attention(q, k, v, *, causal: bool = True, impl: str = "auto",
              block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K):
    """Dispatcher. impl: auto | xla | flash | flash_interpret.

    ``"auto"`` is the kernels for CUDA tensors and the dense version for CPU
    tensors, decided by where the tensors lie, with no probe and no
    fallback. ``"flash_interpret"`` runs the plain blockwise versions,
    forward and backward, on any device (the analog of the JAX kernels'
    interpret mode)."""
    if impl == "auto":
        impl = "flash" if q.is_cuda else "xla"
    if impl == "xla":
        return attention_xla(q, k, v, causal=causal)
    if impl in ("flash", "flash_interpret"):
        return flash_attention(q, k, v, causal, block_q, block_k,
                               interpret=impl == "flash_interpret")
    raise ValueError(f"unknown attention impl {impl}")


# ------------------------------------------------ DTensor sharding rules

def _register_dtensor_strategies() -> None:
    """DTensor strategies of the three custom ops, so that K1, K2 and
    K4+K3 run on DTensors: every tensor replicated, or all sharded alike on
    the batch dim, or on the heads dim (q/k/v/out/dq/dk/dv dim 2, lse dim
    1) when q and k have as many heads (a GQA group must not be split).
    Each is local: the kernel runs on each rank's shard. A
    sequence-sharded input has no strategy here; it goes through
    ``parallel/ring_attention.py``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    def strategies(q, k, n_in, outs):
        """(output placements, input placements) lists: ``n_in`` tensor
        inputs (lse the 5th when present) and outputs shaped by ``outs``
        ("x" for [B, T, H, D], "lse" for [B, H, T])."""
        rep = ([Replicate()] * len(outs), [Replicate()] * n_in)
        out = [rep]
        dims = [(0, 0)]
        if q.shape[2] == k.shape[2]:
            dims.append((2, 1))
        for x_dim, lse_dim in dims:
            place = {"x": Shard(x_dim), "lse": Shard(lse_dim)}
            ins = [Shard(x_dim)] * n_in
            if n_in == 6:
                ins[4] = Shard(lse_dim)
            out.append(([place[o] for o in outs], ins))
        return [(o, i + [None, None, None, None]) for o, i in out]

    @register_sharding(torch.ops.ray_tpu_torch.flash_fwd.default)
    def _fwd(q, k, v, causal, block_q, block_k, interpret):
        return strategies(q, k, 3, ["x"])

    @register_sharding(torch.ops.ray_tpu_torch.flash_fwd_lse.default)
    def _fwd_lse(q, k, v, causal, block_q, block_k, interpret):
        return strategies(q, k, 3, ["x", "lse"])

    @register_sharding(torch.ops.ray_tpu_torch.flash_bwd.default)
    def _bwd(q, k, v, out, lse, do, causal, block_q, block_k, interpret):
        return [(o, i[:6] + [None, None, None, None])
                for o, i in strategies(q, k, 6, ["x", "x", "x"])]


_register_dtensor_strategies()
