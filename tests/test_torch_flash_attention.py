"""The port's plain flash attention against the JAX reference on the CPU:
the reference's Pallas ``flash_attention`` in interpret mode and its
``ref.flash_attention_ref`` over the sweep of ``tests/test_kernels.py``,
the reference's padded kernel path, and gradients against
``jax.grad`` of the reference oracle and of ``_sdpa_direct``.  Inputs are
drawn with numpy from a seed and handed to both packages.

Tolerances: forward float32 atol 2e-5 and bfloat16 atol 2e-2 (the
reference's own kernel-test tolerances); gradients float32 atol 1e-4
(softmax backward summed over ≤ 384 keys in another order).  The CUDA
kernels themselves are held against this plain version on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.nn.attention import AttnSpec as JSpec
from repro.nn.attention import _sdpa_direct as jsdpa
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops

FWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = 1e-4


def _qkv(B, H, Sq, Sk, hd, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, H, Sq, hd)).astype(np.float32),
            r.standard_normal((B, H, Sk, hd)).astype(np.float32),
            r.standard_normal((B, H, Sk, hd)).astype(np.float32))


def _port(q, k, v, dtype, **kw):
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    return tfa.flash_attention_ref(*t, **kw).float().numpy()


def _jax(fn, q, k, v, dtype, **kw):
    a = [jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)]
    return np.asarray(fn(*a, **kw), np.float32)


#: (B, H, Sq, Sk, hd, kwargs): tests/test_kernels.py's flash sweep and
#: head dim 32
SWEEP = [
    *[(B, H, S, S, hd, {"causal": True}) for B, H, S, hd in
      [(1, 1, 128, 64), (2, 2, 256, 64), (1, 2, 384, 128), (1, 1, 128, 256)]],
    *[(1, 2, 256, 256, 64, {"causal": True, "window": w})
      for w in (32, 100, 128)],
    (1, 1, 128, 128, 64, {"causal": True, "softcap": 50.0}),
    (2, 1, 128, 256, 64, {"causal": False}),
    (1, 2, 128, 384, 64, {"causal": False}),
    # head dim 32: the reduced llama3.2-1b's shape, and with every mask
    (2, 8, 128, 128, 32, {"causal": True}),
    (1, 2, 256, 256, 32, {"causal": True, "window": 48, "softcap": 30.0}),
]
IDS = [f"B{B}H{H}Sq{Sq}Sk{Sk}hd{hd}-" + "-".join(f"{k}{v}" for k, v in
                                                 kw.items())
       for B, H, Sq, Sk, hd, kw in SWEEP]


@pytest.mark.parametrize("B,H,Sq,Sk,hd,kw", SWEEP, ids=IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_reference_oracle(B, H, Sq, Sk, hd, kw,
                                                dtype):
    q, k, v = _qkv(B, H, Sq, Sk, hd)
    np.testing.assert_allclose(_port(q, k, v, dtype, **kw),
                               _jax(jref.flash_attention_ref, q, k, v, dtype,
                                    **kw), atol=FWD_TOL[dtype], rtol=0)


@pytest.mark.parametrize("B,H,Sq,Sk,hd,kw", SWEEP, ids=IDS)
def test_plain_version_matches_pallas_interpret(B, H, Sq, Sk, hd, kw):
    """The TPU kernel's own algorithm (blockwise online softmax, 128-row
    blocks), run by the Pallas interpreter."""
    q, k, v = _qkv(B, H, Sq, Sk, hd)
    want = _jax(jflash, q, k, v, "float32", interpret=True, **kw)
    np.testing.assert_allclose(_port(q, k, v, "float32", **kw), want,
                               atol=FWD_TOL["float32"], rtol=0)


@pytest.mark.parametrize("S,hd,kw", [
    (200, 64, {"causal": True}),
    (300, 128, {"causal": True, "window": 40, "softcap": 30.0}),
    (77, 64, {"causal": True}),
])
def test_padding_matches_the_reference_kernel_path(S, hd, kw):
    """The reference's ``ops.flash_attention`` pads Sq and Sk up to its
    128-row blocks before the Pallas kernel; the port's op does not pad
    (its CUDA kernels take any length).  The unpadded call equals the
    reference's padded interpret-mode kernel path."""
    q, k, v = _qkv(1, 2, S, S, hd, seed=S)
    want = _jax(jops.flash_attention, q, k, v, "float32", impl="interpret",
                **kw)
    got = tops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL["float32"],
                               rtol=0)


def test_non_causal_key_padding_raises_as_the_reference():
    """The reference's kernel path refuses a non-causal Sk off its block
    multiple (padded keys would not be masked); the port's op needs no
    padding, takes that shape and equals the reference oracle."""
    q, k, v = _qkv(1, 1, 128, 200, 64)
    with pytest.raises(AssertionError):
        jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                             causal=False, impl="interpret")
    got = tops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=False)
    np.testing.assert_allclose(
        got.numpy(), _jax(jref.flash_attention_ref, q, k, v, "float32",
                          causal=False), atol=FWD_TOL["float32"], rtol=0)


def _port_grads(q, k, v, g, **kw):
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tops.flash_attention(*t, **kw)
    return [x.numpy() for x in torch.autograd.grad(out, t,
                                                   torch.from_numpy(g))]


@pytest.mark.parametrize("B,H,Sq,Sk,hd,kw", SWEEP, ids=IDS)
def test_gradients_match_jax_grad_of_reference_oracle(B, H, Sq, Sk, hd, kw):
    q, k, v = _qkv(B, H, Sq, Sk, hd)
    g = np.random.default_rng(1).standard_normal((B, H, Sq, hd)).astype(
        np.float32)

    def f(q, k, v):
        return jnp.sum(jref.flash_attention_ref(q, k, v, **kw) * g)

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in
                                            (q, k, v)))
    for name, a, b in zip("qkv", _port_grads(q, k, v, g, **kw), want):
        np.testing.assert_allclose(a, np.asarray(b), atol=GRAD_TOL, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("kw", [{"causal": True}, {"causal": True,
                                                   "window": 48},
                                {"causal": True, "softcap": 30.0},
                                {"causal": False}])
def test_gradients_match_jax_grad_of_sdpa_direct(kw):
    """The model's oracle: ``_sdpa_direct`` on (B, S, H, hd) with
    positions ``arange(S)``, which is what the kernel's index masking
    assumes."""
    B, H, S, hd = 2, 4, 96, 64
    q, k, v = _qkv(B, H, S, S, hd, seed=5)
    g = np.random.default_rng(2).standard_normal((B, H, S, hd)).astype(
        np.float32)
    spec = JSpec(n_heads=H, n_kv_heads=H, head_dim=hd, causal=kw["causal"],
                 window=kw.get("window"), logit_softcap=kw.get("softcap"),
                 rope=False)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))

    def f(q, k, v):
        o = jsdpa(*(jnp.moveaxis(a, 1, 2) for a in (q, k, v)), pos, pos,
                  spec)
        return jnp.sum(jnp.moveaxis(o, 2, 1) * g)

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in
                                            (q, k, v)))
    for name, a, b in zip("qkv", _port_grads(q, k, v, g, **kw), want):
        np.testing.assert_allclose(a, np.asarray(b), atol=GRAD_TOL, rtol=0,
                                   err_msg=f"d{name}")


def test_impls_and_devices():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 64, 64, 64))
    torch.testing.assert_close(tops.flash_attention(q, k, v),
                               tops.flash_attention(q, k, v, impl="ref"),
                               atol=0, rtol=0)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="auto/ref/cuda"):
        tops.flash_attention(q, k, v, impl="pallas")
    for fn in (tfa.flash_fwd_cuda, tfa.flash_attention_cuda):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            fn(q, k, v)


def test_fully_masked_row_averages_v_uniformly():
    """Masked logits are -1e30, not -inf: with 8 queries, 2 keys and a
    non-causal window of 1, rows 2..7 see no key (r - c >= 1 for both)
    and get the uniform average of V, as in the reference oracle."""
    q, k, v = _qkv(1, 1, 8, 2, 64)
    kw = {"causal": False, "window": 1}
    out = _port(q, k, v, "float32", **kw)
    np.testing.assert_allclose(out, _jax(jref.flash_attention_ref, q, k, v,
                                         "float32", **kw), atol=2e-5)
    np.testing.assert_allclose(out[0, 0, 2:],
                               np.broadcast_to(v[0, 0].mean(0), (6, 64)),
                               atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_fully_masked_row_gradients_match_jax_grad(causal):
    """Rows that see no key (Sq = 64 queries, Sk = 16 keys, window 8: rows
    23..63) weigh every key 1/Sk in dV and pass no gradient to q or k."""
    q, k, v = _qkv(1, 2, 64, 16, 64, seed=3)
    g = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    kw = {"causal": causal, "window": 8}

    def f(q, k, v):
        return jnp.sum(jref.flash_attention_ref(q, k, v, **kw) * g)

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in
                                            (q, k, v)))
    got = _port_grads(q, k, v, g, **kw)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=GRAD_TOL, rtol=0,
                                   err_msg=f"d{name}")
    assert not got[0][0, :, 23:].any()
