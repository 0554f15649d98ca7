"""The port's paged-decode path against the JAX reference: the plain
gather against ``paged_decode_pallas(interpret=True)`` and the JAX gather
(atol 2e-5: float32 softmax over ≤ 64 keys, summed in another order),
bit-exact pool writes, and the host ``PagePool`` — same tables as the
reference on every sequence that does not fail, all-or-nothing ``grow``
where the reference's is not (fault R3)."""

import random

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
from repro.kernels import paged_attention as jpk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpk

ATOL = 2e-5

CASES = [
    # B, KV, G, hd, ps, P, window, softcap — incl. multi-page spans
    (2, 2, 2, 64, 4, 4, None, None),
    (2, 1, 4, 32, 8, 3, 5, 30.0),
    (1, 4, 1, 16, 4, 3, None, 50.0),
    (3, 2, 4, 32, 4, 5, 7, None),
]


def _setup(B, KV, G, hd, ps, P, *, seed=0, inactive=()):
    """numpy inputs: a permuted page table (row of an inactive slot parked
    on the scratch page), random pools and queries."""
    r = np.random.default_rng(seed)
    N = 1 + B * P
    q = r.standard_normal((B, KV, G, hd)).astype(np.float32)
    kp = r.standard_normal((N, ps, KV, hd)).astype(np.float32)
    vp = r.standard_normal((N, ps, KV, hd)).astype(np.float32)
    table = (1 + r.permutation(B * P)).reshape(B, P).astype(np.int32)
    for b in inactive:
        table[b] = tpk.SCRATCH_PAGE
    return q, kp, vp, table


def _run_all(q, kp, vp, table, q_pos, window, sc):
    jargs = [jnp.asarray(a) for a in (q, kp, vp, table, q_pos)]
    targs = [torch.from_numpy(np.array(a)) for a in (q, kp, vp, table, q_pos)]
    pallas = jpk.paged_decode_pallas(*jargs, window=window, softcap=sc,
                                     interpret=True)
    jgather = jpk.paged_decode_gather(*jargs, window=window, softcap=sc)
    port = tops.paged_attention_decode(*targs, window=window, softcap=sc)
    return np.asarray(pallas), np.asarray(jgather), port.numpy()


@pytest.mark.parametrize("B,KV,G,hd,ps,P,window,sc", CASES)
def test_gather_matches_pallas_interpret_and_jax_gather(B, KV, G, hd, ps, P,
                                                        window, sc):
    # positions spanning >1 page and mid-page, ragged; slot 2 (B=3) is an
    # inactive slot at q_pos=0 on the scratch page
    q_pos = np.asarray([ps * P - 1, ps + 1, 0][:B], np.int32)
    inputs = _setup(B, KV, G, hd, ps, P, inactive=(2,) if B == 3 else ())
    pallas, jgather, port = _run_all(*inputs, q_pos, window, sc)
    np.testing.assert_allclose(port, pallas, atol=ATOL, rtol=0)
    np.testing.assert_allclose(port, jgather, atol=ATOL, rtol=0)


@given(st.integers(0, 63), st.integers(0, 4))
@settings(max_examples=10, deadline=None)
def test_property_any_position_window(q_pos, seed):
    """Positions across page boundaries with a sliding window of 11."""
    q, kp, vp, table = _setup(1, 2, 2, 16, 8, 8, seed=seed)
    pallas, _, port = _run_all(q, kp, vp, table,
                               np.asarray([q_pos], np.int32), 11, None)
    np.testing.assert_allclose(port, pallas, atol=ATOL, rtol=0)


def test_impl_switch():
    q, kp, vp, table = (torch.from_numpy(a) for a in _setup(2, 2, 2, 16, 4, 3))
    q_pos = torch.tensor([5, 0], dtype=torch.int32)
    auto = tops.paged_attention_decode(q, kp, vp, table, q_pos)
    gather = tops.paged_attention_decode(q, kp, vp, table, q_pos,
                                         impl="gather")
    assert torch.equal(auto, gather)    # CPU tensors: auto is the gather
    with pytest.raises(ValueError, match="CUDA"):
        tops.paged_attention_decode(q, kp, vp, table, q_pos, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tpk.paged_decode_cuda(q, kp, vp, table, q_pos)
    with pytest.raises(ValueError, match="unknown"):
        tops.paged_attention_decode(q, kp, vp, table, q_pos, impl="pallas")


# --------------------------------------------------------------------------
# pool writes: bit-exact against the reference
# --------------------------------------------------------------------------


def test_paged_write_bitwise():
    B, KV, hd, ps, P = 3, 2, 16, 4, 3
    _, kp, vp, table = _setup(B, KV, 1, hd, ps, P, seed=1)
    r = np.random.default_rng(2)
    k_new = r.standard_normal((B, KV, hd)).astype(np.float32)
    v_new = r.standard_normal((B, KV, hd)).astype(np.float32)
    q_pos = np.asarray([5, 2, 11], np.int32)
    active = np.asarray([True, False, True])
    jk, jv = jpk.paged_write(*(jnp.asarray(a) for a in (
        kp, vp, k_new, v_new, table, q_pos, active)))
    tk, tv = tpk.paged_write(*(torch.from_numpy(np.array(a)) for a in (
        kp, vp, k_new, v_new, table, q_pos, active)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_paged_write_prefill_bitwise():
    B, S, KV, hd, ps, P = 2, 10, 2, 8, 4, 3
    _, kp, vp, table = _setup(B, KV, 1, hd, ps, P, seed=3)
    r = np.random.default_rng(4)
    k_seq = r.standard_normal((B, S, KV, hd)).astype(np.float32)
    v_seq = r.standard_normal((B, S, KV, hd)).astype(np.float32)
    lengths = np.asarray([10, 6], np.int32)
    jk, jv = jpk.paged_write_prefill(*(jnp.asarray(a) for a in (
        kp, vp, k_seq, v_seq, table, lengths)))
    tk, tv = tpk.paged_write_prefill(*(torch.from_numpy(np.array(a)) for a in (
        kp, vp, k_seq, v_seq, table, lengths)))
    # padded positions all land on the scratch page, where the order of
    # colliding writes is unspecified in both frameworks: compare the
    # allocatable pages bit for bit
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(jv)[1:])


# --------------------------------------------------------------------------
# PagePool
# --------------------------------------------------------------------------


def _state(pool):
    return (list(pool._free), [list(pool.owned_pages(s))
                               for s in range(pool.slots)],
            pool.reserved_pages, pool.table.copy(), pool.preempt_count)


def _same(a, b):
    return (a[0] == b[0] and a[1] == b[1] and a[2] == b[2]
            and np.array_equal(a[3], b[3]) and a[4] == b[4])


@given(st.integers(0, 10_000))
@settings(max_examples=30, deadline=None)
def test_pool_matches_reference_on_succeeding_sequences(seed):
    """Random admit / grow / preempt / reserve / cancel / evict sequences
    that the reference runs without failing give the same tables, free
    lists and reservations in the port."""
    rng = random.Random(seed)
    slots, ps, pps = rng.randint(1, 4), rng.choice([2, 4, 8]), 8
    num_pages = rng.randint(4, 40)
    ref = jpk.PagePool(num_pages, ps, slots, pps)
    port = tpk.PagePool(num_pages, ps, slots, pps)
    live: dict[int, int] = {}
    reservations: list[int] = []
    for _ in range(40):
        op, s = rng.random(), rng.randrange(slots)
        if op < 0.3 and s not in live:
            want = rng.randint(1, ps * pps)
            use_res = bool(reservations) and rng.random() < 0.5
            if use_res:
                want = reservations.pop()
            ok = ref.can_admit(want, from_reservation=use_res)
            assert port.can_admit(want, from_reservation=use_res) == ok
            if not ok and use_res:
                reservations.append(want)
            if ok:
                ref.admit(s, want, from_reservation=use_res)
                port.admit(s, want, from_reservation=use_res)
                live[s] = want
        elif op < 0.45 and s in live:
            want = min(ps * pps, live[s] + rng.randint(0, 2 * ps))
            extra = ref.pages_for(want) - len(ref.owned_pages(s))
            if extra <= ref.available_pages:   # only paths that succeed
                ref.grow(s, want)
                port.grow(s, want)
                live[s] = max(live[s], want)
        elif op < 0.6 and s in live:
            assert ref.preempt(s) == port.preempt(s)
            del live[s]
        elif op < 0.75:
            want = rng.randint(1, ps * pps)
            got = ref.reserve(want)
            assert port.reserve(want) == got
            if got:
                reservations.append(want)
        elif op < 0.85 and reservations:
            want = reservations.pop(rng.randrange(len(reservations)))
            ref.cancel_reservation(want)
            port.cancel_reservation(want)
        elif s in live:
            ref.evict(s)
            port.evict(s)
            del live[s]
        assert _same(_state(ref), _state(port))
        assert port.available_pages == ref.available_pages


@given(st.integers(0, 10_000))
@settings(max_examples=40, deadline=None)
def test_failing_grow_changes_nothing(seed):
    """R3: a ``grow`` that cannot be satisfied raises MemoryError and
    leaves the slot's pages, the free list, the reservation and the table
    exactly as they were."""
    rng = random.Random(seed)
    slots, ps, pps = rng.randint(2, 4), rng.choice([2, 4]), 8
    pool = tpk.PagePool(rng.randint(4, 12), ps, slots, pps)
    for s in range(slots):                      # fill the pool partway
        want = rng.randint(1, ps * 3)
        if pool.can_admit(want):
            pool.admit(s, want)
    if rng.random() < 0.5:
        pool.reserve(rng.randint(1, ps * 2))
    live = [s for s in range(slots) if pool.owned_pages(s)]
    if not live:
        return
    s = rng.choice(live)
    have = len(pool.owned_pages(s))
    want_pages = min(pps, have + pool.available_pages + rng.randint(1, 3))
    if want_pages - have <= pool.available_pages:
        return                                  # would succeed: not R3
    before = _state(pool)
    with pytest.raises(MemoryError):
        pool.grow(s, want_pages * ps)
    assert _same(_state(pool), before)
    assert pool.free_pages + sum(len(pool.owned_pages(x))
                                 for x in range(slots)) == pool.num_pages - 1


def test_admit_from_reservation_and_errors():
    pool = tpk.PagePool(6, 4, 2, 4)
    assert pool.reserve(8)                         # 2 pages withheld
    assert pool.available_pages == 3
    with pytest.raises(MemoryError):
        pool.admit(0, 16)                          # 4 pages > 3 available
    assert _same(_state(pool), (list(range(5, 0, -1)), [[], []], 2,
                                np.zeros((2, 4), np.int32), 0))
    pool.admit(0, 8, from_reservation=True)
    assert pool.reserved_pages == 0 and pool.owned_pages(0) == (1, 2)
    with pytest.raises(ValueError):
        pool.admit(0, 4)                           # already live
    with pytest.raises(ValueError):
        pool.cancel_reservation(4)                 # nothing reserved


@pytest.mark.parametrize("B,KV,P", [
    (8, 8, 128), (4, 8, 35), (4, 16, 35), (2, 2, 37), (2, 2, 40), (3, 2, 5),
    (1, 1, 1), (1, 1, 3), (64, 16, 128), (33, 4, 2048), (1, 32, 7)])
@pytest.mark.parametrize("sms", [132, 114, 1])
def test_decode_splits_cover_every_page_once(B, KV, P, sms):
    """The kernel's split count is a function of the shapes alone: the
    splits' page ranges [s·pps, (s+1)·pps) ∩ [0, P) cover every page of
    the table exactly once, none is empty, there are never more splits
    than pages, and one split once B·KV alone gives BLOCKS_PER_SM blocks
    per SM."""
    splits, pps = tpk.decode_splits(B, KV, P, sms)
    assert 1 <= splits <= P and pps >= 1
    owner = np.full(P, -1)
    for s in range(splits):
        pages = range(s * pps, min((s + 1) * pps, P))
        assert len(pages) > 0, f"split {s} owns no page"
        assert (owner[list(pages)] == -1).all()
        owner[list(pages)] = s
    assert (owner >= 0).all()
    assert pps >= min(P, tpk.MIN_PAGES_PER_SPLIT)
    if B * KV >= tpk.BLOCKS_PER_SM * sms:
        assert splits == 1
    assert tpk.decode_splits(B, KV, P, sms) == (splits, pps)
