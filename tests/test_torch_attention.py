"""Parity of the port's attention ops (ray_tpu_torch.ops.attention) with the
JAX package's (ray_tpu.ops.attention), on the CPU.

The same numpy-seeded f32 inputs go through both. The JAX flash kernels run
in interpret mode, as its own tests run them; the port's CPU path is the
kernels' plain blockwise versions. Bounds: 2e-5 for the forward and its
logsumexp, 2e-4 for gradients, the reference's own f32 tolerances
(tests/test_attention.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.ops import attention as jattn
from ray_tpu_torch.ops import attention as tattn

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)


def _qkv(B, T, H, D, Hkv=None, seed=0):
    r = np.random.RandomState(seed)
    q = r.randn(B, T, H, D).astype(np.float32)
    k = r.randn(B, T, Hkv or H, D).astype(np.float32)
    v = r.randn(B, T, Hkv or H, D).astype(np.float32)
    return q, k, v


def _both(fn_j, fn_t, arrays):
    out_j = np.asarray(fn_j(*(jnp.asarray(a) for a in arrays)))
    out_t = fn_t(*(torch.from_numpy(a) for a in arrays)).numpy()
    return out_j, out_t


@pytest.mark.parametrize(
    "B,T,H,Hkv,D,causal,block",
    [
        (2, 128, 4, 4, 32, True, 64),    # test_flash_matches_xla_causal
        (2, 64, 4, 4, 32, False, 32),    # test_flash_matches_xla_noncausal
        (1, 96, 2, 2, 16, True, 64),     # ragged T
        (1, 96, 2, 2, 16, False, 64),
        (1, 1000, 2, 2, 16, True, 64),
        (1, 1000, 2, 2, 16, False, 64),
        (1, 100, 4, 2, 32, True, 64),    # GQA, ragged
        (1, 100, 4, 2, 32, False, 32),
    ],
)
def test_flash_ref_matches_jax_flash_interpret(B, T, H, Hkv, D, causal, block):
    arrays = _qkv(B, T, H, D, Hkv)
    out_j, out_t = _both(
        lambda q, k, v: jattn.flash_attention(q, k, v, causal, block, block, True),
        lambda q, k, v: tattn.flash_attention_ref(q, k, v, causal, block, block),
        arrays,
    )
    np.testing.assert_allclose(out_t, out_j, **TOL)
    # and against the JAX dense reference
    ref_j = np.asarray(jattn.attention_xla(
        *(jnp.asarray(a) for a in arrays), causal=causal))
    np.testing.assert_allclose(out_t, ref_j, **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Hkv", [4, 2])
def test_attention_xla_matches_jax(causal, Hkv):
    arrays = _qkv(2, 64, 4, 16, Hkv, seed=1)
    out_j, out_t = _both(
        lambda q, k, v: jattn.attention_xla(q, k, v, causal=causal),
        lambda q, k, v: tattn.attention_xla(q, k, v, causal=causal),
        arrays,
    )
    np.testing.assert_allclose(out_t, out_j, **TOL)


def test_attention_xla_bias_and_offsets_match_jax():
    """A chunk of a longer sequence: queries at 32.., keys at 16.., plus a
    bias, as ring/blockwise callers use it."""
    q, k, v = _qkv(1, 32, 2, 16, seed=2)
    bias = np.random.RandomState(3).randn(1, 2, 32, 32).astype(np.float32)
    out_j = np.asarray(jattn.attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        bias=jnp.asarray(bias), q_offset=32, kv_offset=16))
    out_t = tattn.attention_xla(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, bias=torch.from_numpy(bias), q_offset=32, kv_offset=16,
    ).numpy()
    np.testing.assert_allclose(out_t, out_j, **TOL)


def test_dispatcher_on_cpu_tensors():
    """On CPU tensors "auto" is the dense version, "flash" the wrapper's
    plain blockwise path, with and without a gradient to record; none
    launches a kernel."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 80, 2, 16, seed=4))
    before = dict(tattn.launches)
    dense = tattn.attention_xla(q, k, v, causal=True)
    for impl in ("auto", "xla", "flash", "flash_interpret"):
        out = tattn.attention(q, k, v, causal=True, impl=impl,
                              block_q=32, block_k=32)
        torch.testing.assert_close(out, dense, **TOL)
        qg = q.clone().requires_grad_()
        out = tattn.attention(qg, k, v, causal=True, impl=impl,
                              block_q=32, block_k=32)
        torch.testing.assert_close(out, dense, **TOL)
        out.sum().backward()
        assert torch.isfinite(qg.grad).all()
    assert tattn.launches == before
    with pytest.raises(ValueError):
        tattn.attention(q, k, v, impl="ring")


def test_launch_counts_move_from_capture_to_replay():
    """A kernel's wrapper called while its thread captures a CUDA graph
    launches nothing: it adds to the capture's record, not to the launch
    counts, and each replay adds the record. Another thread's launches
    during the capture count as launches."""
    import threading

    before = dict(tattn.launches)
    with tattn.recorded() as rec:
        tattn._count("flash_fwd")
        tattn._count("flash_fwd")
        other = threading.Thread(target=tattn._count, args=("flash_bwd_dq",))
        other.start()
        other.join(timeout=10)
    assert rec == {"flash_fwd": 2, "flash_fwd_lse": 0, "flash_bwd_dkv": 0,
                   "flash_bwd_dq": 0}
    assert tattn.launches == dict(before, flash_bwd_dq=before["flash_bwd_dq"] + 1)
    for _ in range(3):
        tattn.count_replay(rec)
    tattn._count("flash_fwd")   # after the capture: a launch again
    assert tattn.launches["flash_fwd"] == before["flash_fwd"] + 3 * 2 + 1
    for name in tattn.launches:
        tattn.launches[name] = before[name]


def test_flash_ref_bf16_follows_precision_contract():
    """bf16 inputs: the blockwise version casts P to bf16 before PV and
    returns bf16. Bound 2e-2 against the f32 dense version on the same
    bf16 values: one bf16 rounding of P (2^-8 relative) plus the output's
    (2^-8 relative), on outputs of magnitude below ~3."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 96, 2, 32, seed=5))
    out = tattn.flash_attention_ref(q, k, v, True, 32, 32)
    assert out.dtype == torch.bfloat16
    ref = tattn.attention_xla(q.float(), k.float(), v.float(), causal=True)
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)


def test_kernel_ready_copies_only_misaligned_views():
    """The wrapper hands the kernel [B, T, H, D] views through strides when
    they are 16-byte aligned (q/k/v slices of the fused qkv tensor are) and
    makes one contiguous copy otherwise."""
    qkv = torch.zeros(2, 8, 3, 4, 16)
    q = qkv[:, :, 0]
    assert tattn._kernel_ready(q) is q
    odd = torch.zeros(2, 8, 4, 20)[..., 2:18]   # stride 20, offset 2
    fixed = tattn._kernel_ready(odd)
    assert fixed is not odd and fixed.is_contiguous()


@pytest.mark.parametrize(
    "B,T,H,Hkv,D,causal,block",
    [
        (2, 64, 4, 4, 32, True, 32),
        (1, 100, 4, 2, 32, True, 64),    # GQA, ragged
        (1, 100, 4, 2, 32, False, 64),
        (1, 96, 2, 2, 16, True, 64),     # ragged T
        (2, 77, 4, 2, 16, True, 128),    # odd T inside one 128-row tile, GQA
        (1, 300, 2, 2, 16, True, 128),   # 128-row tiles, ragged third tile
    ],
)
def test_flash_ref_lse_matches_jax(B, T, H, Hkv, D, causal, block):
    """``flash_attention_ref(with_lse=True)`` against the JAX forward with
    lse (K2's reference): lse is row 0 of JAX's [B*H, 8, Tq_p], cut to Tq."""
    arrays = _qkv(B, T, H, D, Hkv, seed=6)
    out_j, lse_j = jattn._flash_fwd_impl(
        *(jnp.asarray(a) for a in arrays), causal=causal, block_q=block,
        block_k=block, interpret=True, with_lse=True)
    out_t, lse_t = tattn.flash_attention_ref(
        *(torch.from_numpy(a) for a in arrays), causal, block, block,
        with_lse=True)
    assert lse_t.shape == (B, H, T) and lse_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    lse_j = np.asarray(lse_j)[:, 0, :T].reshape(B, H, T)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, **TOL)


@pytest.mark.parametrize(
    "B,T,H,Hkv,D,causal,block",
    [
        (2, 64, 4, 4, 32, True, 32),     # test_flash_grad_matches_xla
        (1, 100, 4, 2, 32, True, 64),    # test_flash_bwd_kernel_gqa_and_ragged
        (1, 100, 4, 2, 32, False, 64),
        (1, 96, 2, 2, 16, True, 64),     # ragged T
        (2, 77, 4, 2, 16, True, 128),    # odd T inside one 128-row tile, GQA
        (1, 300, 2, 2, 16, True, 128),   # 128-row tiles, ragged third tile
    ],
)
def test_flash_grads_match_jax(B, T, H, Hkv, D, causal, block):
    """dq/dk/dv of the port's ``flash_attention`` on CPU tensors (plain
    forward with lse, then ``flash_attention_bwd_ref``) against ``jax.grad``
    of the JAX ``flash_attention`` in interpret mode (its Pallas backward
    kernels), for the loss <out, g>."""
    q, k, v = _qkv(B, T, H, D, Hkv, seed=7)
    g = np.random.RandomState(8).randn(B, T, H, D).astype(np.float32)

    def loss_j(q, k, v):
        return jnp.vdot(jattn.flash_attention(q, k, v, causal, block, block,
                                              True), jnp.asarray(g))

    grads_j = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2)))(
        *(jnp.asarray(a) for a in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tattn.flash_attention(qt, kt, vt, causal, block, block)
    grads_t = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))
    for gt, gj in zip(grads_t, grads_j):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **GRAD_TOL)


def test_flash_bwd_ref_bf16_follows_precision_contract():
    """bf16 inputs: the blockwise backward casts P and dS to bf16 before
    their products and returns bf16 gradients. Bound 5e-2 against the f32
    dense gradients on the same bf16 values: P and dS each carry one bf16
    rounding (2^-8 relative) into sums over up to 96 keys, plus the
    output's rounding, on gradients of magnitude below ~3."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 96, 4, 32, Hkv=2, seed=9))
    do = torch.from_numpy(
        np.random.RandomState(10).randn(1, 96, 4, 32).astype(np.float32))
    out, lse = tattn.flash_attention_ref(q, k, v, True, 32, 32, with_lse=True)
    grads = tattn.flash_attention_bwd_ref(q, k, v, out, lse,
                                          do.to(torch.bfloat16), True, 32, 32)
    assert all(gr.dtype == torch.bfloat16 for gr in grads)
    q32, k32, v32 = (x.float().requires_grad_() for x in (q, k, v))
    ref = tattn.attention_xla(q32, k32, v32, causal=True)
    ref_grads = torch.autograd.grad(ref, (q32, k32, v32),
                                    do.to(torch.bfloat16).float())
    for gr, rg in zip(grads, ref_grads):
        torch.testing.assert_close(gr.float(), rg, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize(
    "B,T,H,Hkv,D,causal,block",
    [
        (2, 64, 4, 4, 32, True, 32),
        (1, 100, 4, 2, 32, True, 64),    # GQA, ragged
        (1, 100, 4, 2, 32, False, 64),
        (1, 96, 2, 2, 16, True, 64),     # ragged T
        (2, 77, 4, 2, 16, True, 128),    # odd T inside one 128-row tile, GQA
    ],
)
def test_flash_bwd_refs_match_jax_bwd_kernels(B, T, H, Hkv, D, causal, block):
    """Each backward kernel's plain version against the JAX backward
    (``_flash_bwd_impl`` in interpret mode: its Pallas dK/dV and dQ kernels)
    on the JAX forward's out and lse: ``flash_bwd_dq_ref`` (K4's: dq, and
    delta against ``sum(dO * out, -1)``) and ``flash_bwd_dkv_ref`` (K3's: dk
    and dv from that delta). Bound 2e-4, the reference's gradient bound."""
    q, k, v = _qkv(B, T, H, D, Hkv, seed=11)
    do = np.random.RandomState(12).randn(B, T, H, D).astype(np.float32)
    qj, kj, vj, doj = (jnp.asarray(a) for a in (q, k, v, do))
    out_j, lse_j = jattn._flash_fwd_impl(qj, kj, vj, causal=causal,
                                         block_q=block, block_k=block,
                                         interpret=True, with_lse=True)
    dq_j, dk_j, dv_j = jattn._flash_bwd_impl(
        qj, kj, vj, out_j, lse_j, doj, causal=causal, block_q=block,
        block_k=block, interpret=True)
    delta_j = np.asarray(jnp.sum(doj * out_j, -1)).transpose(0, 2, 1)
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    out_t = torch.from_numpy(np.array(out_j))
    lse_t = torch.from_numpy(np.array(lse_j)[:, 0, :T].reshape(B, H, T))
    dq_t, delta_t = tattn.flash_bwd_dq_ref(qt, kt, vt, out_t, lse_t, dot,
                                           causal, block, block)
    assert delta_t.shape == (B, H, T) and delta_t.dtype == torch.float32
    np.testing.assert_allclose(dq_t.numpy(), np.asarray(dq_j), **GRAD_TOL)
    np.testing.assert_allclose(delta_t.numpy(), delta_j, **GRAD_TOL)
    dk_t, dv_t = tattn.flash_bwd_dkv_ref(qt, kt, vt, delta_t, lse_t, dot,
                                         causal, block, block)
    np.testing.assert_allclose(dk_t.numpy(), np.asarray(dk_j), **GRAD_TOL)
    np.testing.assert_allclose(dv_t.numpy(), np.asarray(dv_j), **GRAD_TOL)
