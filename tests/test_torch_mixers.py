"""The recurrent and cross-attention mixers of the port (``nn/rwkv.py``,
``nn/mamba.py``, the cross paths of ``nn/attention.py``) against the JAX
reference, float32 on the CPU, on the reference's own weights and the
same numpy inputs.

The port loops over tokens (RWKV) and runs a doubling scan within each
chunk (Mamba) where the reference uses ``lax.scan`` and
``associative_scan``, so the sums round in another order: outputs and
states are held at rtol/atol 1e-4 (they agree to ~1e-6).  ``return_state``
is held against stepping the port's own decode over the same tokens at
the same tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as jattn
from repro.nn import mamba as jmamba
from repro.nn import rwkv as jrwkv
from repro_torch.nn import attention as tattn
from repro_torch.nn import mamba as tmamba
from repro_torch.nn import rwkv as trwkv

TOL = dict(rtol=1e-4, atol=1e-4)
D, HS = 128, 32                       # d_model, RWKV head size (4 heads)


def _t(tree):
    """A reference parameter tree as torch tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _x(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), **(tol or TOL))


@pytest.fixture(scope="module")
def rwkv_params():
    """Time-mix and channel-mix weights with non-zero LoRA ``b`` (the
    reference initialises them to zero, which would leave the
    data-dependent shift and decay untested)."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    tm = jrwkv.init_time_mix(k1, D, head_size=HS)
    for name, k in (("mix_lora", k2), ("decay_lora", k3)):
        b = tm[name]["b"]
        tm[name] = {**tm[name], "b": jax.random.normal(k, b.shape) * 0.1}
    cm = jrwkv.init_channel_mix(jax.random.PRNGKey(4), D, 256)
    return tm, cm


def test_rwkv_time_mix_and_state_match_reference(rwkv_params):
    tm, _ = rwkv_params
    x = _x(2, 19, D, seed=1)
    jy, jst = jrwkv.time_mix(tm, jnp.asarray(x), head_size=HS,
                             return_state=True)
    ty, tst = trwkv.time_mix(_t(tm), torch.from_numpy(x), head_size=HS,
                             return_state=True)
    _close(ty, jy)
    for k in ("state", "tm_shift"):
        _close(tst[k], jst[k])
    _close(trwkv.time_mix(_t(tm), torch.from_numpy(x), head_size=HS), jy)


def test_rwkv_channel_mix_matches_reference(rwkv_params):
    _, cm = rwkv_params
    x = _x(2, 11, D, seed=2)
    _close(trwkv.channel_mix_seq(_t(cm), torch.from_numpy(x)),
           jrwkv.channel_mix_seq(cm, jnp.asarray(x)))


def test_rwkv_decode_steps_match_reference(rwkv_params):
    """Six decode steps of time-mix and channel-mix from a prefilled
    state; the port's cache is updated in place."""
    tm, cm = rwkv_params
    x = _x(3, 6, D, seed=3)
    pre = _x(3, 5, D, seed=4)
    _, jst = jrwkv.time_mix(tm, jnp.asarray(pre), head_size=HS,
                            return_state=True)
    jc = {**jrwkv.init_rwkv_cache(3, D, head_size=HS), **jst,
          "cm_shift": jnp.asarray(pre[:, -1])}
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    for t in range(x.shape[1]):
        xt = x[:, t:t + 1]
        jy, upd = jrwkv.decode_time_mix(tm, jnp.asarray(xt), jc, head_size=HS)
        jc = {**jc, **upd}
        ty, same = trwkv.decode_time_mix(_t(tm), torch.from_numpy(xt), tc,
                                         head_size=HS)
        assert same is tc
        _close(ty, jy)
        jy, upd = jrwkv.decode_channel_mix(cm, jnp.asarray(xt), jc)
        jc = {**jc, **upd}
        ty, _ = trwkv.decode_channel_mix(_t(cm), torch.from_numpy(xt), tc)
        _close(ty, jy)
    for k in jc:
        _close(tc[k], jc[k])


def test_rwkv_return_state_equals_stepping_decode(rwkv_params):
    tm, _ = rwkv_params
    p = _t(tm)
    x = torch.from_numpy(_x(2, 9, D, seed=5))
    y, st = trwkv.time_mix(p, x, head_size=HS, return_state=True)
    cache = trwkv.init_rwkv_cache(2, D, head_size=HS)
    for t in range(x.shape[1]):
        yt, _ = trwkv.decode_time_mix(p, x[:, t:t + 1], cache, head_size=HS)
        _close(yt[:, 0], y[:, t].numpy())
    for k in ("state", "tm_shift"):
        _close(cache[k], st[k].numpy())


@pytest.fixture(scope="module")
def mamba_params():
    """Mamba weights with a non-zero conv bias and a larger ``dt`` so the
    decays reach well below 1 within a chunk."""
    p = jmamba.init_mamba(jax.random.PRNGKey(1), D, d_state=8, d_conv=4)
    k1, k2 = jax.random.split(jax.random.PRNGKey(2))
    return {**p, "conv_b": jax.random.normal(k1, p["conv_b"].shape) * 0.1,
            "dt_bias": p["dt_bias"] + 2.0
            + jax.random.normal(k2, p["dt_bias"].shape) * 0.5}


@pytest.mark.parametrize("S,chunk", [(24, 8), (23, 8), (3, 512)])
def test_mamba_matches_reference_over_chunks(mamba_params, S, chunk):
    """24 tokens in three chunks of 8 (the state carried across them);
    23 tokens do not divide and run as one chunk, as in the reference;
    3 tokens are fewer than the conv window."""
    x = _x(2, S, D, seed=S)
    jy, jst = jmamba.mamba(mamba_params, jnp.asarray(x), d_state=8,
                           chunk=chunk, return_state=True)
    ty, tst = tmamba.mamba(_t(mamba_params), torch.from_numpy(x), d_state=8,
                           chunk=chunk, return_state=True)
    _close(ty, jy)
    for k in ("h", "conv"):
        _close(tst[k], jst[k])


def test_mamba_decode_steps_match_reference(mamba_params):
    x = _x(2, 7, D, seed=7)
    jc = jmamba.init_mamba_cache(2, D, d_state=8)
    tc = tmamba.init_mamba_cache(2, D, d_state=8)
    for t in range(x.shape[1]):
        xt = x[:, t:t + 1]
        jy, jc = jmamba.decode_mamba(mamba_params, jnp.asarray(xt), jc,
                                     d_state=8)
        ty, same = tmamba.decode_mamba(_t(mamba_params), torch.from_numpy(xt),
                                       tc, d_state=8)
        assert same is tc
        _close(ty, jy)
    for k in jc:
        _close(tc[k], jc[k])


@pytest.mark.parametrize("chunk", [4, 512])
def test_mamba_return_state_equals_stepping_decode(mamba_params, chunk):
    p = _t(mamba_params)
    x = torch.from_numpy(_x(2, 16, D, seed=8))
    y, st = tmamba.mamba(p, x, d_state=8, chunk=chunk, return_state=True)
    cache = tmamba.init_mamba_cache(2, D, d_state=8)
    for t in range(x.shape[1]):
        yt, _ = tmamba.decode_mamba(p, x[:, t:t + 1], cache, d_state=8)
        _close(yt[:, 0], y[:, t].numpy())
    for k in ("h", "conv"):
        _close(cache[k], st[k].numpy())


def test_mamba_scan_holds_decays_that_underflow():
    """A chunk whose ``dt·A`` sums fall far below -800 (where exp of a
    cumulative sum of logs would overflow): the doubling scan of products
    stays finite and equals a token-by-token recurrence."""
    g = torch.Generator().manual_seed(0)
    a = torch.exp(-torch.rand((1, 64, 5, 3), generator=g) * 30.0)
    b = torch.randn((1, 64, 5, 3), generator=g)
    a_cum, h = tmamba._scan(a, b)
    want, hh = [], torch.zeros_like(b[:, 0])
    for t in range(a.shape[1]):
        hh = a[:, t] * hh + b[:, t]
        want.append(hh)
    assert torch.isfinite(h).all() and torch.isfinite(a_cum).all()
    assert a_cum[0, -1].max().item() == 0.0          # underflowed to zero
    torch.testing.assert_close(h, torch.stack(want, 1), rtol=1e-6,
                               atol=1e-6)


SPEC = jattn.AttnSpec(n_heads=4, n_kv_heads=2, head_dim=32, causal=False,
                      rope=False)


def _tspec(spec, **over):
    return tattn.AttnSpec(**{**dataclasses.asdict(spec), **over})


@pytest.fixture(scope="module")
def cross_params():
    return jattn.init_attention(jax.random.PRNGKey(3), D, SPEC)


@pytest.mark.parametrize("rope", [False, True])
def test_cross_attention_matches_reference_attention_with_kv(cross_params,
                                                             rope):
    """``attention(kv_x=)`` with a non-causal spec and
    ``attention_with_kv`` on the projected k/v both equal the reference's
    ``attention_with_kv`` (19 queries over 37 context frames, GQA 2)."""
    spec = dataclasses.replace(SPEC, rope=rope)
    x, ctx = _x(2, 19, D, seed=9), _x(2, 37, D, seed=10)
    pos = np.tile(np.arange(19, dtype=np.int32), (2, 1))
    k = (ctx @ np.asarray(cross_params["wk"])).reshape(2, 37, 2, 32)
    v = (ctx @ np.asarray(cross_params["wv"])).reshape(2, 37, 2, 32)
    want = jattn.attention_with_kv(cross_params, jnp.asarray(x),
                                   jnp.asarray(k), jnp.asarray(v), spec,
                                   positions=jnp.asarray(pos))
    p, ts = _t(cross_params), _tspec(spec)
    _close(tattn.attention_with_kv(p, torch.from_numpy(x),
                                   torch.from_numpy(k), torch.from_numpy(v),
                                   ts, positions=torch.from_numpy(pos)),
           want)
    if not rope:          # attention() ropes the keys at kv_positions
        kpos = torch.arange(37, dtype=torch.int32).expand(2, 37)
        _close(tattn.attention(p, torch.from_numpy(x), ts,
                               positions=torch.from_numpy(pos),
                               kv_x=torch.from_numpy(ctx),
                               kv_positions=kpos), want)


@pytest.mark.parametrize("per_slot", [False, True])
def test_cross_decode_matches_reference(cross_params, per_slot):
    """One-token cross decode over 37 frames, with one index or a (B,)
    vector of per-slot positions (the paged ``attn+cross`` decode), rope
    on so the position matters."""
    spec = dataclasses.replace(SPEC, rope=True)
    x = _x(3, 1, D, seed=11)
    kv = {n: _x(3, 37, 2, 32, seed=12 + i) for i, n in enumerate("kv")}
    index = np.asarray([4, 17, 9], np.int32) if per_slot else 6
    jy, _ = jattn.decode_attention(
        cross_params, jnp.asarray(x), {n: jnp.asarray(a) for n, a in kv.items()},
        jnp.asarray(index), spec, cross=True)
    ty, _ = tattn.decode_attention(
        _t(cross_params), torch.from_numpy(x),
        {n: torch.from_numpy(a) for n, a in kv.items()},
        torch.from_numpy(index) if per_slot else index, _tspec(spec),
        cross=True)
    _close(ty, jy)
