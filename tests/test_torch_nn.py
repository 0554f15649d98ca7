"""The port's NN building blocks against the JAX reference on the same
inputs (numpy, fixed seeds), float32 on the CPU, atol 1e-5 unless
stated (float32 rounding of sums over ≤ a few hundred terms)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.nn import attention as jattn
from repro.nn import base as jbase
from repro.nn import moe as jmoe
from repro_torch.nn import attention as tattn
from repro_torch.nn import base as tbase
from repro_torch.nn import moe as tmoe

ATOL = 1e-5


def rng(seed):
    return np.random.default_rng(seed)


def both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def close(j, t, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=0)


def test_rmsnorm():
    x = rng(0).standard_normal((3, 5, 64)).astype(np.float32) * 3
    w = rng(1).standard_normal(64).astype(np.float32)
    (jx, tx), (jw, tw) = both(x), both(w)
    close(jbase.rmsnorm(jx, jw), tbase.rmsnorm(tx, tw))


def test_layernorm_and_softcap():
    x = rng(2).standard_normal((4, 32)).astype(np.float32) * 2
    p = {"w": rng(3).standard_normal(32).astype(np.float32),
         "b": rng(4).standard_normal(32).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jx, tx = both(x)
    close(jbase.layernorm(jx, jp), tbase.layernorm(tx, tp))
    close(jbase.softcap(jx * 20, 30.0), tbase.softcap(tx * 20, 30.0))


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope_interleaved(fraction):
    x = rng(5).standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    (jx, tx), (jp, tp) = both(x), both(pos)
    j = jbase.apply_rope(jx, jp, theta=500000.0, fraction=fraction)
    t = tbase.apply_rope(tx, tp, theta=500000.0, fraction=fraction)
    close(j, t)
    if fraction < 1.0:      # the unrotated tail passes through untouched
        np.testing.assert_array_equal(t[..., 16:].numpy(), x[..., 16:])


def test_dense_ffn_and_swiglu():
    r = rng(6)
    x = r.standard_normal((2, 3, 32)).astype(np.float32)
    p = {"w1": r.standard_normal((32, 64)).astype(np.float32) / 6,
         "w3": r.standard_normal((32, 64)).astype(np.float32) / 6,
         "w2": r.standard_normal((64, 32)).astype(np.float32) / 8}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jx, tx = both(x)
    close(jmoe.dense_ffn(jp, jx), tmoe.dense_ffn(tp, tx))
    close(jbase.swiglu(jx, jp["w1"], jp["w3"], jp["w2"]),
          tbase.swiglu(tx, tp["w1"], tp["w3"], tp["w2"]))


def _spec(**kw):
    base = dict(n_heads=4, n_kv_heads=2, head_dim=16)
    base.update(kw)
    return jattn.AttnSpec(**base), tattn.AttnSpec(**base)


def _qkv(seed, B, S, H, hd):
    r = rng(seed)
    return [r.standard_normal((B, S, H, hd)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("kw", [
    dict(), dict(window=3), dict(logit_softcap=5.0),
    dict(causal=False), dict(window=4, logit_softcap=2.0)])
def test_sdpa_direct(kw):
    js, ts = _spec(**kw)
    q, k, v = _qkv(7, 2, 9, 4, 16)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
    kpos = pos.copy()
    kpos[1, 6:] = -1                          # padded keys
    args = [both(a) for a in (q, k, v, pos, kpos)]
    j = jattn._sdpa_direct(*[a[0] for a in args], js)
    t = tattn._sdpa_direct(*[a[1] for a in args], ts)
    close(j, t)


@pytest.mark.parametrize("kw", [dict(), dict(window=300, logit_softcap=8.0)])
def test_sdpa_blockwise_past_one_kv_block(kw):
    """S slightly above KV_BLOCK=1024 exercises the padded last block."""
    js, ts = _spec(n_heads=2, n_kv_heads=1, head_dim=8, **kw)
    S = tattn.KV_BLOCK + 37
    q, k, v = _qkv(8, 1, S, 2, 8)
    pos = np.arange(S, dtype=np.int32)[None]
    args = [both(a) for a in (q, k, v, pos, pos)]
    j = jattn._sdpa_blockwise(*[a[0] for a in args], js)
    t = tattn._sdpa_blockwise(*[a[1] for a in args], ts)
    close(j, t)
    # and the blockwise path equals the direct one (same math)
    close(tattn._sdpa_direct(*[a[1] for a in args], ts), t)


def test_expand_kv_and_mask_bias():
    x = rng(9).standard_normal((2, 3, 2, 4)).astype(np.float32)
    jx, tx = both(x)
    close(jattn._expand_kv(jx, 6), tattn._expand_kv(tx, 6), atol=0)
    qp = np.arange(5, dtype=np.int32)[None].repeat(2, 0)
    kp = qp.copy()
    kp[0, 3:] = -1
    (jq, tq), (jk, tk) = both(qp), both(kp)
    close(jattn._mask_bias(jq, jk, causal=True, window=2),
          tattn._mask_bias(tq, tk, causal=True, window=2), atol=0)


def _attn_params(seed, d, spec):
    r = rng(seed)
    H, KV, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    p = {"wq": r.standard_normal((d, H * hd)), "wk": r.standard_normal(
        (d, KV * hd)), "wv": r.standard_normal((d, KV * hd)),
         "wo": r.standard_normal((H * hd, d))}
    p = {k: (v / np.sqrt(v.shape[0])).astype(np.float32) for k, v in p.items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("kw", [dict(rope_theta=500000.0), dict(
    window=4, logit_softcap=20.0, rope_fraction=0.5)])
def test_prefill_attention_ragged_lengths(kw):
    js, ts = _spec(**kw)
    jp, tp = _attn_params(10, 32, js)
    B, S = 3, 11
    x = rng(11).standard_normal((B, S, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    lengths = np.array([11, 6, 1], np.int32)
    (jx, tx), (jpos, tpos), (jl, tl) = both(x), both(pos), both(lengths)
    jo, jk, jv = jattn.prefill_attention(jp, jx, js, positions=jpos,
                                         lengths=jl)
    to, tk, tv = tattn.prefill_attention(tp, tx, ts, positions=tpos,
                                         lengths=tl)
    for b, n in enumerate(lengths):       # rows past a length are garbage
        close(jo[b, :n], to[b, :n])
    close(jk, tk)
    close(jv, tv)
