"""The port's MoE (``repro_torch.nn.moe``, ``repro_torch.kernels.moe`` and
the ``kernels.ops`` dispatch) against the JAX reference on the CPU.

Inputs come from numpy seeds and go to both packages as the same values.
Routing (capacity, expert ids, positions, keep masks, slot maps) is held
exactly equal; router probabilities and gates at atol 1e-6 (float32
softmax in two libraries).  The plain dispatch/combine are held against
the reference's Pallas kernels in interpret mode and its slot versions at
the reference test's tolerances: float32 atol 1e-5, bfloat16 atol 5e-2
(the Pallas kernels form products in float32 and cast, the slot versions
multiply in bfloat16).  ``moe_ffn`` is held against the reference's
``impl="interpret"`` and ``impl="ref"`` in float32 at atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kernels import moe as jmk
from repro.models import decoder as jdec
from repro.nn import moe as jmoe
from repro_torch.configs import get_config as tget
from repro_torch.kernels import _build
from repro_torch.kernels import moe as tmk
from repro_torch.kernels import ops as tops
from repro_torch.models.convert import params_from_jax
from repro_torch.nn import moe as tmoe

# the reference test sweep (tests/test_kernels.py), incl. heavy drops
# (cf 0.25) and top_k = E, plus an OLMoE-like router (64 experts, top-8)
SWEEP = [
    # G, S, D, E, K, cf
    (2, 24, 16, 4, 2, 1.25),
    (1, 64, 32, 8, 2, 1.0),
    (2, 32, 16, 4, 1, 0.25),
    (1, 8, 16, 4, 4, 8.0),
    (4, 1, 32, 64, 8, 1.25),          # OLMoE decode: S=1 per group, C=8
    (1, 96, 32, 64, 8, 1.25),         # OLMoE prefill-like: drops occur
]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _setup(G, S, D, E, K, cf, seed=0):
    """numpy router, expert weights and tokens; the reference's init
    scales (N(0, 1/D) router and inputs, N(0, 1/f) output)."""
    r = np.random.default_rng(seed)
    f = 2 * D
    p = {"router": r.standard_normal((D, E)) / np.sqrt(D),
         "w1": r.standard_normal((E, D, f)) / np.sqrt(D),
         "w3": r.standard_normal((E, D, f)) / np.sqrt(D),
         "w2": r.standard_normal((E, f, D)) / np.sqrt(f)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = r.standard_normal((G, S, D)).astype(np.float32)
    return p, x, jmoe.moe_capacity(S, E, K, cf)


def _route_both(p, x, K, C):
    j = jmoe.moe_route(jnp.asarray(p["router"]), jnp.asarray(x), top_k=K,
                       capacity=C)
    t = tmoe.moe_route(torch.from_numpy(p["router"]), torch.from_numpy(x),
                       top_k=K, capacity=C)
    return [np.array(a) for a in j], [a.numpy() for a in t]


def test_moe_capacity_equals_reference_on_a_grid():
    for S in (1, 2, 7, 24, 64, 96, 512, 1000, 4096):
        for E in (1, 4, 8, 64, 128):
            for K in (1, 2, 4, 8):
                for cf in (0.25, 0.5, 1.0, 1.25, 2.0, 8.0):
                    assert tmoe.moe_capacity(S, E, K, cf) == \
                        jmoe.moe_capacity(S, E, K, cf), (S, E, K, cf)
    assert tmoe.moe_capacity(1, 64, 8) == 8          # OLMoE decode
    assert tmoe.moe_capacity(512, 64, 8) == 80       # OLMoE 512-token prefill


@pytest.mark.parametrize("G,S,D,E,K,cf", SWEEP)
def test_moe_route_matches_reference(G, S, D, E, K, cf):
    p, x, C = _setup(G, S, D, E, K, cf)
    (jp, jg, je, jpos, jk), (tp, tg, te, tpos, tk) = _route_both(p, x, K, C)
    np.testing.assert_allclose(tp, jp, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tg, jg, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(tpos, jpos)
    np.testing.assert_array_equal(tk, jk)
    assert te.dtype == tpos.dtype == np.int32


def test_moe_route_orders_ties_lower_index_first():
    """A zero router gives every expert the same probability:
    ``jax.lax.top_k`` then picks experts 0..K-1 in order."""
    G, S, D, E, K = 2, 5, 8, 16, 4
    router = np.zeros((D, E), np.float32)
    x = np.random.default_rng(1).standard_normal((G, S, D)).astype(
        np.float32)
    (_, jg, je, jpos, jk), (_, tg, te, tpos, tk) = _route_both(
        {"router": router}, x, K, 8)
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(te.reshape(G, S, K)[0, 0], np.arange(K))
    np.testing.assert_array_equal(tpos, jpos)
    np.testing.assert_allclose(tg, jg, atol=1e-6, rtol=0)


@pytest.mark.parametrize("G,S,D,E,K,cf", SWEEP)
def test_slot_maps_sources_and_weights_equal_reference(G, S, D, E, K, cf):
    p, x, C = _setup(G, S, D, E, K, cf)
    (_, jg, je, jpos, jk), _ = _route_both(p, x, K, C)
    wtok = (jg.reshape(G, S * K) * jk).astype(np.float32)
    j_nk = jmk.slot_maps(jnp.asarray(je), jnp.asarray(jpos),
                         jnp.asarray(jk), num_experts=E, capacity=C)
    t_nk = tmk.slot_maps(torch.from_numpy(je), torch.from_numpy(jpos),
                         torch.from_numpy(jk), num_experts=E, capacity=C)
    np.testing.assert_array_equal(t_nk.numpy(), np.asarray(j_nk))
    np.testing.assert_array_equal(
        tmk.slot_sources(t_nk, top_k=K).numpy(),
        np.asarray(jmk.slot_sources(j_nk, top_k=K)))
    np.testing.assert_array_equal(
        tmk.slot_weights(t_nk, torch.from_numpy(wtok)).numpy(),
        np.asarray(jmk.slot_weights(j_nk, jnp.asarray(wtok))))


def _slot_inputs(G, S, D, E, K, cf):
    """Routing of the sweep case as numpy: x, slot_src, slot_w, eid, pos
    (dropped pairs at position 0) and the gate·keep weight."""
    p, x, C = _setup(G, S, D, E, K, cf)
    (_, jg, je, jpos, jk), _ = _route_both(p, x, K, C)
    nk = jmk.slot_maps(jnp.asarray(je), jnp.asarray(jpos), jnp.asarray(jk),
                       num_experts=E, capacity=C)
    src = np.array(jmk.slot_sources(nk, top_k=K))
    sw = np.array(jmk.slot_weights(nk, jnp.asarray(jk, jnp.float32)))
    w = (jg.reshape(G, S * K) * jk).astype(np.float32).reshape(G, S, K)
    pos = np.where(jk, jpos, 0).reshape(G, S, K).astype(np.int32)
    return x, src, sw, je.reshape(G, S, K), pos, w, C


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("G,S,D,E,K,cf", SWEEP[:4])
def test_dispatch_and_combine_slot_match_reference(G, S, D, E, K, cf,
                                                   dtype):
    jdt, tdt, atol = DTYPES[dtype]
    x, src, sw, eid, pos, w, C = _slot_inputs(G, S, D, E, K, cf)
    xj, xt = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    got = tmk.dispatch_slot(xt, torch.from_numpy(src), torch.from_numpy(sw))
    assert got.dtype == tdt and got.shape == (G, E, C, D)
    for want in (jmk.dispatch_pallas(xj, jnp.asarray(src), jnp.asarray(sw),
                                     num_experts=E, capacity=C,
                                     interpret=True),
                 jmk.dispatch_slot(xj, jnp.asarray(src), jnp.asarray(sw))):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=atol,
                                   rtol=0)
    # combine the reference's slab back, as moe_ffn does after the experts
    buf = np.array(jmk.dispatch_slot(jnp.asarray(x), jnp.asarray(src),
                                       jnp.asarray(sw)))
    bj, bt = jnp.asarray(buf, jdt), torch.from_numpy(buf).to(tdt)
    got = tmk.combine_slot(bt, torch.from_numpy(eid), torch.from_numpy(pos),
                           torch.from_numpy(w))
    assert got.dtype == tdt and got.shape == (G, S, D)
    for want in (jmk.combine_pallas(bj, jnp.asarray(eid), jnp.asarray(pos),
                                    jnp.asarray(w), interpret=True),
                 jmk.combine_slot(bj, jnp.asarray(eid), jnp.asarray(pos),
                                  jnp.asarray(w))):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=atol,
                                   rtol=0)


@pytest.mark.parametrize("G,S,D,E,K,cf", SWEEP[:5])
def test_combine_slot_ordered_matches_combine_slot_and_reference(G, S, D, E,
                                                                 K, cf):
    """The k-ordered plain combine (the CUDA kernel's rounding) against
    ``combine_slot`` and the reference's interpret-mode Pallas combine,
    float32 at atol 1e-6 (the same products summed in another order or
    with fused multiply-adds), and bit for bit against the same sum written
    as a numpy float32 loop: one rounded product and one rounded add per
    k, from 0, in k order.  In bfloat16 it casts once: it equals its own
    float32 result on the bf16 slab, cast."""
    x, src, sw, eid, pos, w, C = _slot_inputs(G, S, D, E, K, cf)
    buf = np.array(jmk.dispatch_slot(jnp.asarray(x), jnp.asarray(src),
                                     jnp.asarray(sw)))
    args = [torch.from_numpy(a) for a in (eid, pos, w)]
    got = tmk.combine_slot_ordered(torch.from_numpy(buf), *args)
    assert got.dtype == torch.float32 and got.shape == (G, S, D)
    picked = buf[np.arange(G)[:, None, None], eid, pos]     # (G, S, K, D)
    acc = np.zeros((G, S, D), np.float32)
    for k in range(K):
        acc = acc + picked[:, :, k] * w[:, :, k, None]
    np.testing.assert_array_equal(got.numpy(), acc)
    for want in (tmk.combine_slot(torch.from_numpy(buf), *args).numpy(),
                 jmk.combine_pallas(jnp.asarray(buf), jnp.asarray(eid),
                                    jnp.asarray(pos), jnp.asarray(w),
                                    interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)
    bt = torch.from_numpy(buf).to(torch.bfloat16)
    torch.testing.assert_close(
        tmk.combine_slot_ordered(bt, *args),
        tmk.combine_slot_ordered(bt.float(), *args).to(torch.bfloat16),
        atol=0, rtol=0)


def test_combine_slot_ordered_clamps_as_combine_slot():
    r = np.random.default_rng(4)
    G, S, D, E, C, K = 2, 5, 8, 4, 8, 3
    buf = torch.from_numpy(r.standard_normal((G, E, C, D)).astype(np.float32))
    eid = torch.from_numpy(r.integers(-2, E + 3, (G, S, K)).astype(np.int32))
    pos = torch.from_numpy(r.integers(-2, C + 5, (G, S, K)).astype(np.int32))
    w = torch.from_numpy(r.random((G, S, K)).astype(np.float32))
    torch.testing.assert_close(tmk.combine_slot_ordered(buf, eid, pos, w),
                               tmk.combine_slot(buf, eid, pos, w), atol=1e-6,
                               rtol=0)


def test_plain_versions_clamp_out_of_range_indices_as_jax_does():
    """Source rows past S-1, expert ids past E-1 and positions past C-1
    read the last row, as a JAX gather clamps them (the CUDA kernels
    clamp the same way)."""
    r = np.random.default_rng(3)
    G, S, D, E, C, K = 2, 5, 8, 4, 8, 3
    x = r.standard_normal((G, S, D)).astype(np.float32)
    src = r.integers(-1, S + 3, (G, E, C)).astype(np.int32)
    sw = r.standard_normal((G, E, C)).astype(np.float32)
    np.testing.assert_array_equal(
        tmk.dispatch_slot(torch.from_numpy(x), torch.from_numpy(src),
                          torch.from_numpy(sw)).numpy(),
        np.asarray(jmk.dispatch_slot(jnp.asarray(x), jnp.asarray(src),
                                     jnp.asarray(sw))))
    buf = r.standard_normal((G, E, C, D)).astype(np.float32)
    eid = r.integers(0, E + 3, (G, S, K)).astype(np.int32)
    pos = r.integers(0, C + 5, (G, S, K)).astype(np.int32)
    w = r.standard_normal((G, S, K)).astype(np.float32)
    np.testing.assert_allclose(
        tmk.combine_slot(torch.from_numpy(buf), torch.from_numpy(eid),
                         torch.from_numpy(pos), torch.from_numpy(w)).numpy(),
        np.asarray(jmk.combine_slot(jnp.asarray(buf), jnp.asarray(eid),
                                    jnp.asarray(pos), jnp.asarray(w))),
        atol=1e-6, rtol=0)


def test_empty_slot_holds_zero_times_row_zero():
    """An empty slot is 0·x[g, 0], not a literal zero: a non-finite row 0
    shows through, as it does in the reference."""
    x = torch.ones((1, 3, 4))
    x[0, 0, 1] = float("inf")
    out = tmk.dispatch_slot(x, torch.tensor([[[-1, 2]]], dtype=torch.int32),
                            torch.tensor([[[0.0, 1.0]]]))
    want = jmk.dispatch_slot(jnp.asarray(x.numpy()),
                             jnp.asarray([[[-1, 2]]], jnp.int32),
                             jnp.asarray([[[0.0, 1.0]]]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert torch.isnan(out[0, 0, 0, 1]) and torch.equal(out[0, 0, 1],
                                                        torch.ones(4))


@pytest.mark.parametrize("G,S,D,E,K,cf", SWEEP)
def test_moe_ffn_matches_reference(G, S, D, E, K, cf):
    p, x, _ = _setup(G, S, D, E, K, cf)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    want = {impl: jmoe.moe_ffn(jp, jnp.asarray(x), top_k=K,
                               capacity_factor=cf, impl=impl)
            for impl in ("interpret", "ref")}
    for timpl in ("auto", "slot", "ref"):
        y, aux = tmoe.moe_ffn(tp, torch.from_numpy(x), top_k=K,
                              capacity_factor=cf, impl=timpl)
        for jy, jaux in want.values():
            np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                                       rtol=0)
            assert float(aux["aux_loss"]) == pytest.approx(
                float(jaux["aux_loss"]), abs=1e-6)
            assert float(aux["dropped"]) == pytest.approx(
                float(jaux["dropped"]), abs=1e-6)
    if cf == 0.25 or S == 96:          # the cases with dropped pairs
        assert float(aux["dropped"]) > 0


def test_moe_ffn_on_reduced_olmoe_layer_weights():
    """Layer 0 of the reduced OLMoE, as ``params_from_jax`` converts the
    reference's ``init_model`` tree, on a 40-token sequence."""
    tcfg = tget("olmoe-1b-7b", reduced=True)
    jcfg = jget("olmoe-1b-7b", reduced=True)
    jparams = jdec.init_model(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    jf = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["ffn"])
    tf = {k: v[0] for k, v in tparams["blocks"][0]["ffn"].items()}
    x = np.random.default_rng(4).standard_normal(
        (1, 40, tcfg.d_model)).astype(np.float32)
    K = tcfg.moe_top_k
    jy, jaux = jmoe.moe_ffn(jf, jnp.asarray(x), top_k=K, impl="interpret")
    ty, taux = tmoe.moe_ffn(tf, torch.from_numpy(x), top_k=K)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    assert float(taux["dropped"]) == pytest.approx(float(jaux["dropped"]),
                                                   abs=1e-6)


def test_moe_forward_is_moe_ffns_output():
    """The serve path's ``moe_forward`` (no aux-loss work) gives exactly
    ``moe_ffn``'s y, for every impl."""
    p, x, _ = _setup(2, 24, 16, 4, 2, 1.25)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    for impl in ("auto", "slot", "ref"):
        y, _ = tmoe.moe_ffn(tp, torch.from_numpy(x), top_k=2, impl=impl)
        torch.testing.assert_close(
            tmoe.moe_forward(tp, torch.from_numpy(x), top_k=2, impl=impl), y,
            atol=0, rtol=0)


def test_moe_route_has_no_host_sync_ops():
    """moe_route / slot_maps give tensors, never Python numbers: the
    routing of a decode step stays on the device."""
    p, x, C = _setup(4, 1, 32, 64, 8, 1.25)
    out = tmoe.moe_route(torch.from_numpy(p["router"]), torch.from_numpy(x),
                         top_k=8, capacity=C)
    assert all(isinstance(t, torch.Tensor) for t in out)
    _, aux = tmoe.moe_ffn({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x), top_k=8)
    assert all(isinstance(v, torch.Tensor) for v in aux.values())


# --------------------------------------------------------------------------
# dispatch choices, wrappers and the autograd guard (no card needed)
# --------------------------------------------------------------------------


def _tiny_route():
    x, src, sw, eid, pos, w, C = _slot_inputs(2, 24, 16, 4, 2, 1.25)
    return x, eid, pos, w, C


def test_ops_auto_on_cpu_takes_the_slot_version():
    x, eid, pos, w, C = _tiny_route()
    G, S, K = eid.shape
    keep = (w != 0).reshape(G, S * K).astype(np.float32)
    args = (torch.from_numpy(x), torch.from_numpy(eid.reshape(G, S * K)),
            torch.from_numpy(pos.reshape(G, S * K)), torch.from_numpy(keep))
    n = (tmk.moe_dispatch_cuda.launches, tmk.moe_combine_cuda.launches)
    a = tops.moe_dispatch(*args, num_experts=4, capacity=C, top_k=K)
    b = tops.moe_dispatch(*args, num_experts=4, capacity=C, top_k=K,
                          impl="slot")
    assert torch.equal(a, b)
    y = tops.moe_combine(a, torch.from_numpy(eid), torch.from_numpy(pos),
                         torch.from_numpy(w))
    assert y.shape == (G, S, x.shape[-1])
    assert (tmk.moe_dispatch_cuda.launches,
            tmk.moe_combine_cuda.launches) == n


@pytest.mark.parametrize("impl", ["interpret", "pallas", "ref", "nope"])
def test_ops_rejects_impls_the_port_does_not_have(impl):
    x, eid, pos, w, _ = _tiny_route()
    with pytest.raises(ValueError, match="auto/slot/cuda"):
        tops.moe_combine(torch.zeros((2, 4, 8, 16)), torch.from_numpy(eid),
                         torch.from_numpy(pos), torch.from_numpy(w),
                         impl=impl)


def test_ops_cuda_impl_raises_for_cpu_tensors():
    x, eid, pos, w, _ = _tiny_route()
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.moe_combine(torch.zeros((2, 4, 8, 16)), torch.from_numpy(eid),
                         torch.from_numpy(pos), torch.from_numpy(w),
                         impl="cuda")


def test_ops_positions_auto_on_cpu_is_the_cumsum():
    """On CPU tensors ``auto`` and ``slot`` give the one-hot cumsum's
    positions and launch nothing; drops are where the cumsum reaches the
    capacity."""
    _, _, je, jpos, _ = _route_both(*_setup(1, 96, 32, 64, 8, 1.25)[:2],
                                    8, 16)[0]
    eid = torch.from_numpy(je).long()
    n = tmk.moe_positions_cuda.launches
    want = tmk.positions_cumsum(eid, capacity=16, num_experts=64)
    for impl in ("auto", "slot"):
        pos, keep = tops.moe_positions(eid, capacity=16, num_experts=64,
                                       impl=impl)
        assert pos.dtype == torch.int32 and keep.dtype == torch.bool
        assert torch.equal(pos, want[0]) and torch.equal(keep, want[1])
    np.testing.assert_array_equal(want[0].numpy(), jpos)
    assert not bool(want[1].all())
    assert tmk.moe_positions_cuda.launches == n


@pytest.mark.parametrize("impl", ["interpret", "pallas", "ref", "nope"])
def test_ops_positions_rejects_impls_the_port_does_not_have(impl):
    with pytest.raises(ValueError, match="auto/slot/cuda"):
        tops.moe_positions(torch.zeros((2, 8), dtype=torch.int64),
                           capacity=8, num_experts=4, impl=impl)


def test_ops_positions_cuda_impl_raises_for_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.moe_positions(torch.zeros((2, 8), dtype=torch.int64),
                           capacity=8, num_experts=4, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tmk.moe_positions_cuda(torch.zeros((2, 8), dtype=torch.int64), 8, 4)


@pytest.mark.parametrize("E", [0, tmk.POSITIONS_MAX_EXPERTS + 1, 512])
def test_positions_wrapper_raises_past_the_kernels_expert_limit(E):
    with pytest.raises(ValueError, match="experts"):
        tmk.moe_positions_cuda(torch.zeros((2, 8), dtype=torch.int64), 8, E)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_positions_fake_implementation_gives_shapes_and_dtypes(dtype):
    """Under ``FakeTensorMode`` the custom op ``repro_torch::moe_positions``
    runs its fake implementation: int32 positions and a bool mask of the
    routing's shape, launching nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    n = tmk.moe_positions_cuda.launches
    with FakeTensorMode():
        eid = torch.empty((3, 40), dtype=dtype)
        pos, keep = tmk.moe_positions_cuda(eid, 16, 64)
        assert pos.shape == keep.shape == (3, 40)
        assert pos.dtype == torch.int32 and keep.dtype == torch.bool
    assert tmk.moe_positions_cuda.launches == n


def test_wrappers_take_cuda_tensors_only():
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tmk.moe_dispatch_cuda(torch.zeros((1, 2, 4)),
                              torch.zeros((1, 2, 8), dtype=torch.int32),
                              torch.zeros((1, 2, 8)))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tmk.moe_combine_cuda(torch.zeros((1, 2, 8, 4)),
                             *[torch.zeros((1, 2, 1), dtype=torch.int32)] * 2,
                             torch.zeros((1, 2, 1)))


def test_refuse_autograd_names_the_training_slice():
    """The refusal names where the gradient comes from instead: for the
    MoE launchers, the training slice's autograd Functions."""
    a = torch.zeros(3, requires_grad=True)
    why = "its gradient comes from MoeDispatch"
    with pytest.raises(RuntimeError, match=why):
        _build.refuse_autograd("k", torch.zeros(2, dtype=torch.int32), a,
                               reason=why)
    with torch.no_grad():
        _build.refuse_autograd("k", a, reason=why)
    _build.refuse_autograd("k", torch.zeros(3),
                           torch.zeros(2, dtype=torch.int32), reason=why)


def test_plain_versions_stay_differentiable():
    x = torch.randn((1, 4, 8), requires_grad=True)
    src = torch.tensor([[[0, 3], [1, -1]]], dtype=torch.int32)
    out = tmk.dispatch_slot(x, src, torch.tensor([[[1.0, 2.0], [0.5, 0.0]]]))
    out.sum().backward()
    assert x.grad[0, 3].eq(2.0).all() and x.grad[0, 2].eq(0.0).all()


def test_library_path_hashes_only_the_kernels_own_sources(tmp_path,
                                                          monkeypatch):
    """Editing one kernel's .cu leaves another kernel's library name as it
    is; a shared .cuh moves both."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a\n")
    (csrc / "b.cu").write_text("// b\n")
    (csrc / "common.cuh").write_text("// shared\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    a0, b0 = _build._library_path("a"), _build._library_path("b")
    assert a0 != b0 and a0.parent == tmp_path / "_build"
    (csrc / "b.cu").write_text("// b, edited\n")
    assert _build._library_path("a") == a0
    b1 = _build._library_path("b")
    assert b1 != b0
    (csrc / "common.cuh").write_text("// shared, edited\n")
    assert _build._library_path("a") != a0
    assert _build._library_path("b") != b1


def test_params_from_jax_rejects_a_wrong_moe_tree():
    tcfg = tget("olmoe-1b-7b", reduced=True)
    jparams = jdec.init_model(jget("olmoe-1b-7b", reduced=True),
                              jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    ffn = tree["blocks"][0]["ffn"]
    tree["blocks"][0]["ffn"] = {**ffn, "w2": ffn["w2"][:, :, :-1]}
    with pytest.raises(ValueError, match="MoE ffn leaves"):
        params_from_jax(tree, tcfg, device="cpu")
    tree["blocks"][0]["ffn"] = {k: v for k, v in ffn.items() if k != "router"}
    with pytest.raises(ValueError, match="MoE ffn leaves"):
        params_from_jax(tree, tcfg, device="cpu")
