"""Paged KV-cache decode attention: host page pool, plain PyTorch version,
pool writes and the wrapper of the CUDA kernel (port of
``repro.kernels.paged_attention``).

KV state lives in a **shared page pool** per attention layer:

* ``k_pages / v_pages: (num_pages, page_size, KV, hd)`` — shared by every
  sequence in the batch.  Page 0 is a reserved scratch page: inactive
  batch slots park their writes there so the decode step stays
  branch-free.
* ``page_table: (B, pages_per_seq) int32`` — per-sequence logical →
  physical page map (:class:`PagePool` owns allocation on the host).
  Logical position ``t`` of sequence ``b`` lives at
  ``k_pages[page_table[b, t // page_size], t % page_size]``.

Decode attention has two implementations of one function:
:func:`paged_decode_gather` (plain PyTorch: gather the table's pages,
mask, softmax — the CPU path and the reference the kernel is held
against) and :func:`paged_decode_cuda`, which launches the hand-written
Hopper kernel ``csrc/paged_decode.cu`` and works on CUDA tensors only.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import _build

NEG_INF = -1e30

#: page 0 is never allocated: it is the scratch page inactive slots
#: write to
SCRATCH_PAGE = 0


# --------------------------------------------------------------------------
# host-side page pool (allocation / admit / evict)
# --------------------------------------------------------------------------


class PagePool:
    """Host-side allocator for the shared KV page pool.

    Pages are identified by physical index ``1 .. num_pages-1`` (page 0
    is the reserved scratch page).  ``table`` is the dense
    ``(slots, pages_per_seq)`` page-table array the device kernels
    consume; unallocated entries point at the scratch page.

    Invariants (property-tested in ``tests/test_torch_paged_attention.py``):
      * no physical page is owned by two live slots;
      * ``free + Σ owned == num_pages - 1`` across any admit/preempt/
        evict sequence; reservations withhold availability without
        moving pages;
      * every mutation is all-or-nothing: a call that raises leaves the
        free list, the owned pages, the reservation and the table as
        they were (the reference's ``grow`` took pages before running
        dry; this one checks the need first).

    :meth:`preempt` releases a live slot's pages like :meth:`evict` but
    counts the event; :meth:`reserve` withholds free pages from ordinary
    admissions, and ``admit(..., from_reservation=True)`` consumes them.
    """

    def __init__(self, num_pages: int, page_size: int, slots: int,
                 pages_per_seq: int):
        if num_pages < 2:
            raise ValueError("need at least one allocatable page")
        self.num_pages = num_pages
        self.page_size = page_size
        self.slots = slots
        self.pages_per_seq = pages_per_seq
        # LIFO free list: recently freed (cache-warm) pages go out first
        self._free: list[int] = list(range(num_pages - 1, 0, -1))
        self._owned: list[list[int]] = [[] for _ in range(slots)]
        self._reserved = 0
        self.preempt_count = 0
        self.table = np.full((slots, pages_per_seq), SCRATCH_PAGE, np.int32)

    # -- queries ----------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def reserved_pages(self) -> int:
        return self._reserved

    @property
    def available_pages(self) -> int:
        """Free pages not withheld by a reservation."""
        return len(self._free) - self._reserved

    def owned_pages(self, slot: int) -> tuple[int, ...]:
        return tuple(self._owned[slot])

    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` cache entries."""
        return max(1, -(-tokens // self.page_size))

    def can_admit(self, tokens: int, *, from_reservation: bool = False) -> bool:
        n = self.pages_for(tokens)
        avail = len(self._free) if from_reservation else self.available_pages
        return n <= self.pages_per_seq and n <= avail

    # -- mutations --------------------------------------------------------

    def reserve(self, tokens: int) -> bool:
        """Withhold the pages ``tokens`` positions need from ordinary
        admissions; ``False`` (no-op) when they are not available."""
        n = self.pages_for(tokens)
        if n > self.pages_per_seq or n > self.available_pages:
            return False
        self._reserved += n
        return True

    def cancel_reservation(self, tokens: int) -> None:
        """Return a :meth:`reserve`-d allotment to general availability."""
        n = self.pages_for(tokens)
        if n > self._reserved:
            raise ValueError(
                f"cancelling {n} pages but only {self._reserved} reserved")
        self._reserved -= n

    def admit(self, slot: int, tokens: int, *,
              from_reservation: bool = False) -> None:
        """Allocate pages covering ``tokens`` positions to an empty slot.

        ``from_reservation=True`` consumes a matching :meth:`reserve`
        allotment instead of drawing on general availability."""
        if self._owned[slot]:
            raise ValueError(f"slot {slot} already live")
        n = self.pages_for(tokens)
        if n > self.pages_per_seq:
            raise ValueError(
                f"{tokens} tokens need {n} pages > pages_per_seq="
                f"{self.pages_per_seq}")
        if from_reservation and n > self._reserved:
            raise ValueError(
                f"admit from_reservation needs {n} pages but only "
                f"{self._reserved} are reserved")
        # a reservation's pages are this admission's own to take
        avail = len(self._free) if from_reservation else self.available_pages
        if n > avail:
            raise MemoryError(
                f"pool exhausted: need {n} pages, {avail} available "
                f"({len(self._free)} free, {self._reserved} reserved)")
        if from_reservation:
            self._reserved -= n
        self.grow(slot, tokens)      # cannot fail now: n <= available

    def preempt(self, slot: int) -> int:
        """Release a live slot's pages back to the pool so a more urgent
        request can run; the host keeps the sequence's tokens and resumes
        it later via prefill.  Returns the number of pages freed."""
        n = len(self._owned[slot])
        if n == 0:
            raise ValueError(f"slot {slot} is not live — nothing to preempt")
        self.evict(slot)
        self.preempt_count += 1
        return n

    def grow(self, slot: int, tokens: int) -> None:
        """Extend a slot's allocation to cover ``tokens`` positions, all
        or nothing: the need is checked against the available (free and
        unreserved) pages before any page is taken."""
        need = self.pages_for(tokens)
        if need > self.pages_per_seq:
            raise ValueError(f"{tokens} tokens exceed pages_per_seq capacity")
        owned = self._owned[slot]
        extra = need - len(owned)
        if extra <= 0:
            return
        if extra > self.available_pages:
            raise MemoryError(
                f"pool exhausted: slot {slot} needs {extra} more pages, "
                f"{self.available_pages} available")
        for _ in range(extra):
            pid = self._free.pop()
            self.table[slot, len(owned)] = pid
            owned.append(pid)

    def evict(self, slot: int) -> None:
        """Free all of a slot's pages back to the pool."""
        while self._owned[slot]:
            self._free.append(self._owned[slot].pop())
        self.table[slot, :] = SCRATCH_PAGE


# --------------------------------------------------------------------------
# plain PyTorch version (the CPU path and the kernel's reference)
# --------------------------------------------------------------------------


def paged_decode_gather(q, k_pages, v_pages, page_table, q_pos, *,
                        window: int | None = None,
                        softcap: float | None = None):
    """q: (B, KV, G, hd) grouped queries; k/v_pages: (N, ps, KV, hd);
    page_table: (B, P) int32; q_pos: (B,) int32 — the new token's
    position.  Returns (B, KV, G, hd) in q's dtype.

    Gathers the sequence's table pages into (B, P·ps, KV, hd), masks to
    the live span ``max(0, q_pos-window+1) .. q_pos`` and runs the grouped
    GQA softmax in f32 — the reference's op order."""
    B, KV, G, hd = q.shape
    ps = k_pages.shape[1]
    P = page_table.shape[1]
    pt = page_table.long()
    kg = k_pages[pt].reshape(B, P * ps, KV, hd).to(q.dtype)
    vg = v_pages[pt].reshape(B, P * ps, KV, hd).to(q.dtype)
    kpos = torch.arange(P * ps, dtype=torch.int32, device=q.device)[None]
    qp = q_pos.to(torch.int32)[:, None]
    valid = kpos <= qp
    if window is not None:
        valid &= kpos > (qp - window)

    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bkgd,bskd->bkgs", q, kg).float() * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(vg.dtype)
    return torch.einsum("bkgs,bskd->bkgd", w, vg)


# --------------------------------------------------------------------------
# the CUDA kernel's wrapper
# --------------------------------------------------------------------------

#: head dims the kernel is built for
KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FNS = None

#: blocks the split count aims at per SM, and the fewest pages a split
#: gets (one for each of a block's 4 warps)
BLOCKS_PER_SM = 4
MIN_PAGES_PER_SPLIT = 4


def decode_splits(B: int, KV: int, P: int, sms: int) -> tuple[int, int]:
    """``(splits, pages_per_split)`` of the paged-decode kernel's grid
    (B·KV, splits): split ``s`` owns the logical pages ``[s·pps,
    min((s+1)·pps, P))``.  A function of the shapes alone (never of
    ``q_pos``, which stays on the card): enough blocks for
    ``BLOCKS_PER_SM`` per SM, at least ``MIN_PAGES_PER_SPLIT`` pages a
    split, no split without a page, and one split once B·KV fills the
    card."""
    want = max(1, -(-BLOCKS_PER_SM * sms // (B * KV)))
    pps = min(P, max(MIN_PAGES_PER_SPLIT, -(-P // want)))
    return -(-P // pps), pps


_SMS: dict[int, int] = {}


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        props = torch.cuda.get_device_properties(idx)
        _SMS[idx] = props.multi_processor_count
    return _SMS[idx]


def _kernel_fn():
    global _FNS
    if _FNS is None:
        lib = _build.load("paged_decode")
        fn = lib.paged_decode
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.paged_decode_error_string.argtypes = [ctypes.c_int]
        lib.paged_decode_error_string.restype = ctypes.c_char_p
        _FNS = (fn, lib.paged_decode_error_string)
    return _FNS


def paged_decode_cuda(q, k_pages, v_pages, page_table, q_pos, *,
                      window: int | None = None,
                      softcap: float | None = None):
    """Launch the Hopper paged-decode kernel (``csrc/paged_decode.cu``).

    Same contract as :func:`paged_decode_gather`; CUDA tensors only, q
    and the pools in one dtype (float32 or bfloat16), every tensor
    contiguous and 16-byte aligned.  Raises on anything the kernel does
    not take, when the launch is refused, and under autograd (the kernel
    has no backward).  The pages of each (b, kv) are split over
    :func:`decode_splits` blocks, whose f32 partials go to scratch from
    ``torch.empty`` and are merged by the entry point's combine kernel.
    ``paged_decode_cuda.launches`` counts the calls of the entry point."""
    tensors = (q, k_pages, v_pages, page_table, q_pos)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("paged_decode_cuda takes CUDA tensors only")
    _build.refuse_autograd(
        "paged_decode_cuda", *tensors,
        reason="paged decode serves decode steps and has no backward "
               "kernel (the reference has none either)")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("paged_decode_cuda: tensors on different devices")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"paged_decode_cuda: q dtype {q.dtype} is not "
                         "float32 or bfloat16")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("paged_decode_cuda: q and the page pools need one "
                         f"dtype, got {q.dtype}/{k_pages.dtype}/"
                         f"{v_pages.dtype}")
    if page_table.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise ValueError("paged_decode_cuda: page_table and q_pos must be "
                         "int32")
    if q.dim() != 4 or k_pages.dim() != 4 or page_table.dim() != 2:
        raise ValueError("paged_decode_cuda: expected q (B,KV,G,hd), pages "
                         "(N,ps,KV,hd), page_table (B,P)")
    B, KV, G, hd = q.shape
    N, ps = k_pages.shape[:2]
    P = page_table.shape[1]
    if (k_pages.shape != (N, ps, KV, hd) or v_pages.shape != k_pages.shape
            or page_table.shape[0] != B or q_pos.shape != (B,)):
        raise ValueError(
            f"paged_decode_cuda: shapes disagree: q {tuple(q.shape)}, "
            f"k {tuple(k_pages.shape)}, v {tuple(v_pages.shape)}, "
            f"table {tuple(page_table.shape)}, q_pos {tuple(q_pos.shape)}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"paged_decode_cuda: head_dim {hd} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if min(B, KV, G, N, ps, P) < 1:
        raise ValueError("paged_decode_cuda: empty dimension")
    if window is not None and window < 1:
        raise ValueError(f"paged_decode_cuda: window {window} < 1")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_cuda: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("paged_decode_cuda: q and the page pools must be "
                         "16-byte aligned (the kernel copies 16-byte chunks)")

    fn, err_str = _kernel_fn()
    out = torch.empty_like(q)
    splits, pps = decode_splits(B, KV, P, _sm_count(q.device))
    part = (torch.empty(B * KV * splits * (G * hd + 2 * G),
                        dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 page_table.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
                 None if part is None else part.data_ptr(), B, KV, G, hd, N,
                 ps, P, splits, pps, window or 0, float(softcap or 0.0),
                 1.0 / math.sqrt(hd), _KERNEL_DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"paged_decode kernel launch failed at G={G}, hd={hd}, "
            f"page_size={ps}, splits={splits}: {err_str(err).decode()} "
            f"(cudaError {err}; a block's shared memory grows with G, hd "
            "and page_size)")
    paged_decode_cuda.launches += 1
    return out


paged_decode_cuda.launches = 0


# --------------------------------------------------------------------------
# pool writes (shared by decode step and prefill)
# --------------------------------------------------------------------------


def paged_write(k_pages, v_pages, k_new, v_new, page_table, q_pos, active):
    """Write one token's k/v (B, KV, hd) into each sequence's page for
    position ``q_pos``.  Inactive or out-of-capacity slots are steered to
    the scratch page (live pages are never touched by dead slots).

    Writes **in place** (``index_put_`` on the pools, which the caller
    owns) and returns the same two tensors."""
    ps = k_pages.shape[1]
    P = page_table.shape[1]
    q_pos = q_pos.long()
    logical = torch.clamp(q_pos // ps, max=P - 1)
    pid = torch.gather(page_table.long(), 1, logical[:, None])[:, 0]
    ok = active & (q_pos < P * ps)
    pid = torch.where(ok, pid, SCRATCH_PAGE)
    row = q_pos % ps
    k_pages.index_put_((pid, row), k_new.to(k_pages.dtype))
    v_pages.index_put_((pid, row), v_new.to(v_pages.dtype))
    return k_pages, v_pages


def paged_write_prefill(k_pages, v_pages, k_seq, v_seq, page_table, lengths):
    """Scatter a whole prefilled sequence (B, S, KV, hd) into the pool in
    one shot; positions ≥ the sequence's true length land on the scratch
    page (right-padded batched prefill).  In place, like
    :func:`paged_write`."""
    B, S = k_seq.shape[:2]
    ps = k_pages.shape[1]
    P = page_table.shape[1]
    t = torch.arange(S, device=k_seq.device)[None]              # (1, S)
    logical = torch.clamp(t // ps, max=P - 1).expand(B, S)
    pid = torch.gather(page_table.long(), 1, logical)             # (B, S)
    ok = (t < lengths.long()[:, None]) & (t < P * ps)
    pid = torch.where(ok, pid, SCRATCH_PAGE)
    row = (t % ps).expand(B, S)
    k_pages.index_put_((pid, row), k_seq.to(k_pages.dtype))
    v_pages.index_put_((pid, row), v_seq.to(v_pages.dtype))
    return k_pages, v_pages
