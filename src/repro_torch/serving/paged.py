"""Paged KV cache with shared-prefix reuse.

The counterpart of ``repro.serving.paged``.  The slot pool
(``serving.kvpool.KVPool``) reserves a full ``max_len`` stripe per slot, so
*slot occupancy* -- not tokens actually held -- caps concurrency.  This
module replaces the stripe with fixed-size **pages** behind a per-slot page
table:

  * physical storage is one arena per cache tensor with the ``(batch,
    seq)`` axes refactored to ``(page, page_size)``.  The port keeps one
    cache dict per layer with the slot on axis 0, so each arena tensor is
    ``(n_pages + 1, P, ...)`` with the page on axis 0 (the reference stacks
    layers: its ``(L, B, S, ...)`` leaf becomes ``(L, n_pages + 1, P,
    ...)``).  The extra last page is the immutable **null page** (floats 0,
    ``pos = -1``) every unmapped page-table entry resolves to;
  * the *logical* per-slot cache the engine consumes is materialised on
    access by gathering each slot's page list into a contiguous ``(B,
    seq_len, ...)`` tensor -- the slot pool's exact shape and layout, so the
    decode step launches the same kernels on the same bytes -- and
    scattered back on assignment, so ``pool.cache`` keeps the slot pool's
    contract and the attention code in ``models/`` is untouched (the ``pos
    >= 0`` validity mask already makes the gather order-independent);
  * pages are allocated on demand from a free list as prefill chunks and
    decode steps advance a slot's write high-water mark, and returned with
    refcount accounting when the slot frees.  The page table, refcounts and
    free lists live on the host in numpy; the ``(B, J)`` page index goes to
    the device once per gather or scatter.

**Shared-prefix reuse** rides on the refcounts: a radix-style
:class:`PrefixCache` keyed on page-sized token-id chunks maps requests that
share a prompt prefix onto the *same* immutable pages (refcount +1 per
mapper), so the shared prefill is skipped; the page containing the first
diverging position is **copied-on-write** before any write lands in it
(``prepare_write``), which is also what protects a shared page when an SWA
ring wrap would overwrite it.

The scatter writes every mapped row of every slot, so unmapped entries (the
null page) and shared prefix pages receive writes from several slots at
once: an index copy with duplicate indices, whose order is undefined on
CUDA.  That is harmless only because the bytes are identical under the
``prepare_write`` discipline: nothing writes a row the table does not map
(the null rows stay 0 / -1) and a shared page is copied before any write
lands in it.

Bit-exactness: in fp mode the materialised logical cache is byte-identical
to the slot pool's, so paged continuous serving gives bit-identical tokens
(``tests/test_torch_paged_sched.py``).  Under kv8 the arena quantizes **at
page granularity**: ``quantize_kv`` keeps axes 0 and 2, which on an arena
tensor are the page and the head, so its scales are the reference's
per-(layer, page[, head]) scales and shared pages quantize identically for
every request mapping them.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.obs import profile as _obs_profile
from repro_torch.serving.kvpool import _nbytes, _tensors, check_next_pos, dequantize_kv, quantize_kv


class PageExhausted(RuntimeError):
    """The page free list is empty; the caller must reclaim or evict."""


def _is_pos_group(node: Any) -> bool:
    """An attention block-cache dict: {k, v, pos} or {c_kv, k_rope, pos}."""
    return isinstance(node, dict) and "pos" in node and not isinstance(node["pos"], dict)


def _map(fn, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to the tensors of ``tree`` (and the matching ones of
    ``rest``), keeping the dict / list structure."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, *xs) for xs in zip(tree, *rest, strict=True))
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# Page-arena primitives.  Every arena tensor carries the page on axis 0, as
# the slot pool carries the slot, so one tree map covers k/v/pos and MLA's
# latents.  A logical row r of a slot with page list idx lives at arena row
# idx[r // P] * P + r % P of the tensor viewed as ((n_pages + 1) * P, ...).
# ---------------------------------------------------------------------------


def _rows(idx: torch.Tensor, page_size: int, seq_len: int) -> torch.Tensor:
    """(B, J) physical page ids -> (B * seq_len,) flat arena rows: the first
    ``seq_len`` rows of each slot's pages, in logical order."""
    b, j = idx.shape
    rows = idx[:, :, None] * page_size + torch.arange(page_size, device=idx.device)
    return rows.reshape(b, j * page_size)[:, :seq_len].reshape(-1)


def _gather_pages(phys: Any, idx: torch.Tensor, seq_len: int, page_size: int) -> Any:
    """Materialise the logical cache: idx (B, J) physical page ids (the null
    page for unmapped entries) -> tensors (B, seq_len, ...), contiguous.
    Where J * P exceeds ``seq_len`` the rows past it are never read (the
    reference slices them off)."""
    b = idx.shape[0]
    rows = _rows(idx, page_size, seq_len)

    def g(leaf):
        flat = leaf.view(-1, *leaf.shape[2:])
        return flat.index_select(0, rows).view(b, seq_len, *leaf.shape[2:])

    return _map(g, phys)


def _scatter_pages(phys: Any, logical: Any, idx: torch.Tensor, seq_len: int, page_size: int) -> Any:
    """Write the logical cache back into its mapped pages, in place; returns
    ``phys``.

    Unmapped entries point at the null page and their logical content is
    the null content (0 / -1) by the prepare-write discipline, so the
    duplicate writes they produce change nothing; pages shared by several
    slots receive identical bytes from each (immutable prefix pages), so
    the order of duplicate-index writes is irrelevant.  Rows of a slot's
    last page past ``seq_len`` are not written: they hold the null content,
    which is what the reference's padded scatter writes there.
    """
    rows = _rows(idx, page_size, seq_len)

    def s(p, l):
        p.view(-1, *p.shape[2:]).index_copy_(0, rows, l.reshape(-1, *l.shape[2:]).to(p.dtype))
        return p

    return _map(s, phys, logical)


def _copy_page(phys: Any, src: int, dst: int) -> Any:
    """Duplicate physical page ``src`` into ``dst``, in place: the
    copy-on-write primitive and -- with ``src`` = the null page -- the page
    blanker."""
    def c(leaf):
        leaf[dst].copy_(leaf[src])
        return leaf

    return _map(c, phys)


# ---------------------------------------------------------------------------
# Prefix cache: a radix keyed on page-sized token-id chunks.
# ---------------------------------------------------------------------------


class PrefixCache:
    """Maps page-aligned prompt prefixes onto immutable physical pages.

    Keys are the *full* token prefix covering pages ``0..j`` as raw bytes
    (``tokens[: (j+1) * page_size].tobytes()``), which makes every entry a
    radix-tree node: a lookup walks page by page and stops at the first
    missing key, so a hit is always a chain from the root.  The cache holds
    one refcount on every page it indexes; entries therefore keep their
    pages alive after the registering request finishes -- that is the whole
    point -- and ``reclaim`` (LRU, descendants evicted with their ancestor
    so no chain is ever orphaned) gives the pages back under pressure.
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._pages: dict[bytes, int] = {}
        self._stamp: dict[bytes, int] = {}  # LRU clock per root..j chain key
        self._clock = 0
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._pages)

    def pids(self) -> set[int]:
        return set(self._pages.values())

    def _key(self, tokens: np.ndarray, j: int) -> bytes:
        return np.ascontiguousarray(tokens[: (j + 1) * self.page_size]).tobytes()

    def _touch(self, key: bytes) -> None:
        self._clock += 1
        self._stamp[key] = self._clock

    def lookup(self, tokens: np.ndarray) -> list[int]:
        """Longest chain of cached full pages for this prompt, capped so at
        least one token is left to prefill (the last-position logits must
        come from a real forward pass)."""
        max_pages = (len(tokens) - 1) // self.page_size
        pids: list[int] = []
        for j in range(max_pages):
            key = self._key(tokens, j)
            pid = self._pages.get(key)
            if pid is None:
                break
            self._touch(key)
            pids.append(pid)
        if pids:
            self.hits += 1
        else:
            self.misses += 1
        return pids

    def insert(self, tokens: np.ndarray, j: int, pid: int) -> bool:
        """Index page ``j`` of this prompt; False if already present."""
        key = self._key(tokens, j)
        if key in self._pages:
            self._touch(key)
            return False
        self._pages[key] = pid
        self._touch(key)
        return True

    def evict_chain(self, key: bytes) -> list[int]:
        """Drop ``key`` and every descendant entry (longer keys extending
        it); returns the released pids.  Evicting mid-chain would orphan
        the deeper entries -- unreachable by any walk yet still holding
        refcounts -- so descendants always leave with their ancestor."""
        victims = [k for k in self._pages if len(k) >= len(key) and k[: len(key)] == key]
        pids = []
        for k in victims:
            pids.append(self._pages.pop(k))
            self._stamp.pop(k, None)
        return pids


# ---------------------------------------------------------------------------
# The paged pool.
# ---------------------------------------------------------------------------


class PagedKVPool:
    """Drop-in replacement for :class:`~repro_torch.serving.kvpool.KVPool`
    backed by a page arena.

    Same slot-lifecycle surface (``alloc``/``free``/``write_prefill``/
    ``gather_slot``/``write_slot``/``pos_vector``/``advance`` and the
    ``cache`` property the decode tick round-trips), plus the paging surface
    the scheduler drives:

      * ``prepare_write(slot, start, end)`` -- map pages on demand to cover
        logical rows ``[0, end)`` and copy-on-write any *shared* page
        overlapping ``[start, end)``; raises :class:`PageExhausted` when
        the free list runs dry (the scheduler then reclaims prefix pages
        or preempts a request -- the pool never evicts on its own);
      * ``lookup_prefix`` / ``attach_prefix`` / ``register_prefix`` -- the
        shared-prefix fast path;
      * ``reclaim_prefix_pages`` -- LRU eviction of cache-only pages;
      * ``bytes_report`` -- {"reserved": allocated-page bytes, "live":
        written-row bytes} (the tokens-actually-held footprint).

    ``cache`` and ``gather_slot`` return fresh tensors; a write into them
    reaches the arena only when assigned back (``pool.cache = ...``,
    ``write_slot``).  Supports the attention families only (every cache
    tensor must live in a ``pos``-masked block-cache dict).  ``device``
    defaults to the card.
    """

    def __init__(self, model, n_slots: int, max_len: int, quantize_kv_cache: bool = False, page_size: int = 16,
                 n_pages: int | None = None, prefix_cache: bool = False,
                 device: str | torch.device | None = None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.device = resolve_device(device)
        self.dtype = getattr(torch, model.cfg.dtype)
        self.quantize_kv = quantize_kv_cache
        self.page_size = page_size

        template = model.init_cache(1, max_len, self.dtype, self.device)
        groups: list[dict] = []

        def scan(node):
            if _is_pos_group(node):
                groups.append(node)
            elif isinstance(node, dict):
                for v in node.values():
                    scan(v)
            elif isinstance(node, (list, tuple)):
                for v in node:
                    scan(v)

        scan(template)
        sizes = {int(g["pos"].shape[1]) for g in groups}
        in_groups = sum(len(list(_tensors(g))) for g in groups)
        if not sizes or in_groups != len(list(_tensors(template))):
            raise ValueError("PagedKVPool needs every cache tensor inside a pos-masked attention block cache; "
                             "state-cache families (ssm/hybrid) must use the unpaged KVPool")
        if len(sizes) != 1:
            raise ValueError(f"mixed cache sequence capacities {sizes}")
        (self.seq_len,) = sizes  # == max_len, or the SWA window
        self.pages_per_slot = -(-self.seq_len // page_size)
        self.n_pages = n_pages if n_pages is not None else n_slots * self.pages_per_slot
        if self.n_pages < self.pages_per_slot:
            raise ValueError(f"n_pages={self.n_pages} cannot hold even one full slot "
                             f"({self.pages_per_slot} pages)")
        self.null_pid = self.n_pages

        def arena(leaf):
            fill = 0 if leaf.is_floating_point() else -1
            return torch.full((self.n_pages + 1, page_size, *leaf.shape[2:]), fill, dtype=leaf.dtype,
                              device=self.device)

        self._qphys = None
        self._fphys = None
        self.phys = _map(arena, template)
        del template

        # host bookkeeping (mirrors KVPool.positions / _free at page level)
        self.positions = np.full((n_slots,), -1, np.int64)
        self._pt = np.full((n_slots, self.pages_per_slot), -1, np.int64)
        self._ref = np.zeros((self.n_pages,), np.int64)
        self._hw = np.zeros((n_slots,), np.int64)  # written-row high water
        self._free_pages = list(range(self.n_pages - 1, -1, -1))
        self._free_slots = list(range(n_slots - 1, -1, -1))
        self.prefix = PrefixCache(page_size) if prefix_cache else None

    # -- resident storage (fp, or int8 + per-page scales under kv8) ------------

    @property
    def phys(self) -> Any:
        """The fp arena: the resident tensors, or under kv8 a fresh
        dequantized copy (write it back by assigning)."""
        if self.quantize_kv:
            return dequantize_kv(self._qphys, self.dtype)
        return self._fphys

    @phys.setter
    def phys(self, new: Any) -> None:
        if self.quantize_kv:
            self._qphys = quantize_kv(new)
        else:
            self._fphys = new

    def _resident(self) -> Any:
        return self._qphys if self.quantize_kv else self._fphys

    # -- logical cache (the engine-facing tree) --------------------------------

    def _idx(self, rows: np.ndarray | None = None) -> torch.Tensor:
        pt = self._pt if rows is None else self._pt[rows]
        return torch.as_tensor(np.where(pt < 0, self.null_pid, pt), dtype=torch.int64).to(self.device)

    @property
    def cache(self) -> Any:
        # The decode-path page gather is the paged pool's overhead over the
        # slot pool; sampled timing makes it a measured number.
        return _obs_profile.sample_call(
            "kv.gather", lambda: _gather_pages(self.phys, self._idx(), self.seq_len, self.page_size),
            pool="paged", path="cache")

    @cache.setter
    def cache(self, new: Any) -> None:
        def _scatter() -> Any:
            self.phys = _scatter_pages(self.phys, new, self._idx(), self.seq_len, self.page_size)
            return self._resident()

        _obs_profile.sample_call("kv.scatter", _scatter, pool="paged", path="cache")

    # -- bookkeeping -------------------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free_slots)

    @property
    def n_active(self) -> int:
        return self.n_slots - len(self._free_slots)

    @property
    def pages_free(self) -> int:
        return len(self._free_pages)

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free_pages)

    def occupancy(self) -> float:
        return self.n_active / self.n_slots

    def page_occupancy(self) -> float:
        return self.pages_in_use / self.n_pages

    def active_slots(self) -> list[int]:
        free = set(self._free_slots)
        return [s for s in range(self.n_slots) if s not in free]

    def page_bytes(self) -> int:
        """Device bytes of one physical page in the *resident* form -- under
        kv8 the int8 rows plus that page's fp32 scales."""
        return _nbytes(self._resident()) // (self.n_pages + 1)

    def bytes_resident(self) -> int:
        """Bytes held by *allocated* pages (the paged footprint: memory
        scales with pages in use, not with n_slots * max_len)."""
        return self.pages_in_use * self.page_bytes()

    def bytes_report(self) -> dict:
        """{"reserved": allocated-page bytes, "live": written-row bytes}.

        ``live`` counts rows actually written (each slot's high-water mark,
        prefix pages counted once through page accounting): allocated pages
        are full except the top page of each slot that owns it exclusively.
        """
        pb = self.page_bytes()
        live_rows = self.page_size * self.pages_in_use
        for s in range(self.n_slots):
            mapped = int(np.sum(self._pt[s] >= 0))
            if not mapped:
                continue
            top = self._pt[s][mapped - 1]
            if self._ref[top] == 1:
                live_rows -= mapped * self.page_size - int(self._hw[s])
        return {"reserved": self.pages_in_use * pb, "live": max(0, live_rows) * pb // self.page_size}

    # -- page-table internals ----------------------------------------------------

    def _alloc_page(self) -> int:
        if not self._free_pages:
            raise PageExhausted(f"page free list empty ({self.n_pages} pages, {self.n_active} active slots)")
        pid = self._free_pages.pop()
        assert self._ref[pid] == 0, f"page {pid} reused with refcount {self._ref[pid]}"
        self._ref[pid] = 1
        return pid

    def _release_pages(self, pids: list[int]) -> None:
        """Drop one reference per pid; blank and free the ones reaching 0."""
        dead = []
        for pid in pids:
            assert self._ref[pid] > 0, f"double free of page {pid}"
            self._ref[pid] -= 1
            if self._ref[pid] == 0:
                dead.append(pid)
        for pid in dead:
            self.phys = _copy_page(self.phys, self.null_pid, pid)
        self._free_pages.extend(dead)

    def prepare_write(self, slot: int, start: int, end: int) -> None:
        """Make logical rows ``[start, end)`` of ``slot`` writable.

        Maps missing pages up to ``end`` (allocation on demand) and
        copies-on-write every page overlapping the write range whose
        refcount exceeds one -- shared prefix pages are immutable, so the
        boundary page a suffix prefill or an SWA ring wrap is about to
        touch is duplicated first.  Raises :class:`PageExhausted` (state
        unchanged for the failing page) when the free list is empty.
        """
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"prepare_write on invalid slot {slot}")
        end = min(end, self.seq_len)
        need = -(-end // self.page_size)
        for j in range(self.pages_per_slot):
            if j >= need:
                break
            if self._pt[slot, j] < 0:
                self._pt[slot, j] = self._alloc_page()
            elif self._ref[self._pt[slot, j]] > 1 and (j + 1) * self.page_size > start:
                src = int(self._pt[slot, j])
                dst = self._alloc_page()
                self.phys = _copy_page(self.phys, src, dst)
                self._ref[src] -= 1
                self._pt[slot, j] = dst
        self._hw[slot] = max(self._hw[slot], end)

    def warmup(self) -> None:
        """The first launches of the page copy (COW and page blanking share
        one primitive) as a null -> null no-op, outside any latency window."""
        self.phys = _copy_page(self.phys, self.null_pid, self.null_pid)

    # -- slot lifecycle ----------------------------------------------------------

    def alloc(self) -> int | None:
        if not self._free_slots:
            return None
        return self._free_slots.pop()

    def free(self, slot: int) -> None:
        """Release a slot: unmap its pages (refcounted -- shared prefix pages
        survive while the prefix cache or another slot holds them; exclusive
        pages are blanked and returned to the free list, which is what makes
        the freed slot's old keys unreachable)."""
        if slot in self._free_slots or not 0 <= slot < self.n_slots:
            raise ValueError(f"free of invalid/already-free slot {slot}")
        pids = [int(p) for p in self._pt[slot] if p >= 0]
        self._pt[slot] = -1
        self.positions[slot] = -1
        self._hw[slot] = 0
        self._release_pages(pids)
        self._free_slots.append(slot)

    def write_prefill(self, slot: int, cache_one: Any, n_tokens: int) -> None:
        self.prepare_write(slot, 0, min(n_tokens, self.seq_len))
        self.write_slot(slot, cache_one, next_pos=n_tokens)

    def gather_slot(self, slot: int) -> Any:
        """Batch-1 materialised copy of ``slot`` (shared prefix pages
        included -- this is what a suffix prefill chunk attends to)."""
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"gather of invalid slot {slot}")
        return _obs_profile.sample_call(
            "kv.gather", lambda: _gather_pages(self.phys, self._idx(np.asarray([slot])), self.seq_len,
                                               self.page_size),
            pool="paged", path="slot")

    def write_slot(self, slot: int, cache_one: Any, next_pos: int | None) -> None:
        """Scatter a batch-1 cache into ``slot``'s mapped pages.  The caller
        must have ``prepare_write``-covered every row the engine wrote (rows
        landing on unmapped entries would vanish into the null page --
        ``validate()`` flags the resulting inconsistency)."""
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"write of invalid slot {slot}")
        if any(t.shape[0] != 1 for t in _tensors(cache_one)):
            raise ValueError("write_slot expects a batch-1 cache")
        next_pos = check_next_pos(next_pos)

        def _scatter() -> Any:
            self.phys = _scatter_pages(self.phys, cache_one, self._idx(np.asarray([slot])), self.seq_len,
                                       self.page_size)
            return self._resident()

        _obs_profile.sample_call("kv.scatter", _scatter, pool="paged", path="slot")
        if next_pos is not None:
            self.positions[slot] = next_pos

    # -- decode-step interface ---------------------------------------------------

    def pos_vector(self) -> torch.Tensor:
        """(n_slots,) int32 per-slot positions on the pool's device."""
        return torch.as_tensor(self.positions, dtype=torch.int32).to(self.device)

    def advance(self, slots) -> None:
        for s in slots:
            self.positions[s] += 1

    def decode_write_index(self, slot: int) -> int:
        """Logical row the next decode step writes for this slot (the ring
        rule: absolute position p lives at p % seq_len once wrapped)."""
        p = int(self.positions[slot])
        return p if p < self.seq_len else p % self.seq_len

    # -- shared-prefix reuse -----------------------------------------------------

    def lookup_prefix(self, tokens: np.ndarray) -> tuple[int, list[int]]:
        """(hit tokens, physical page chain) for this prompt's tokens -- (0,
        []) when the prefix cache is off or cold."""
        if self.prefix is None:
            return 0, []
        pids = self.prefix.lookup(np.asarray(tokens))
        return len(pids) * self.page_size, pids

    def attach_prefix(self, slot: int, pids: list[int]) -> None:
        """Map a freshly allocated slot onto cached prefix pages (refcount +1
        each; the pages stay immutable for this slot until ``prepare_write``
        copies the one it must write)."""
        assert not np.any(self._pt[slot] >= 0), "attach_prefix on a used slot"
        # Validate the whole chain before touching the table: a NaN or
        # out-of-range pid rejected mid-loop would leave earlier pages
        # refcounted against a half-mapped slot.
        if len(pids) > self.pages_per_slot:
            raise ValueError(f"attach_prefix: chain of {len(pids)} pages exceeds the "
                             f"{self.pages_per_slot}-page table row")
        clean = []
        for pid in pids:
            f = float(pid)
            if f != f or f != int(f):  # NaN or non-integral
                raise ValueError(f"attach_prefix: NaN-shaped page id {pid!r} -- page-table indices must be "
                                 f"integral")
            p = int(f)
            if not 0 <= p < self.n_pages:
                raise ValueError(f"attach_prefix: page id {p} outside [0, {self.n_pages})")
            clean.append(p)
        for j, pid in enumerate(clean):
            self._pt[slot, j] = pid
            self._ref[pid] += 1
        self._hw[slot] = len(clean) * self.page_size

    def register_prefix(self, slot: int, tokens: np.ndarray, n_tokens: int) -> int:
        """Index this slot's full prompt pages in the prefix cache (refcount
        +1 per newly indexed page).  Skipped entirely when the prompt wrapped
        the ring (cache row != absolute position) -- returns the number of
        pages newly indexed."""
        if self.prefix is None or n_tokens > self.seq_len:
            return 0
        tokens = np.asarray(tokens)
        new = 0
        for j in range(min(n_tokens, len(tokens)) // self.page_size):
            pid = int(self._pt[slot, j])
            if pid < 0:
                break
            if self.prefix.insert(tokens, j, pid):
                self._ref[pid] += 1
                new += 1
        return new

    def reclaim_prefix_pages(self, n_needed: int = 1) -> int:
        """Evict LRU prefix-cache chains whose pages are cache-only (refcount
        1) until ``n_needed`` pages are free; returns how many were actually
        reclaimed.  Chains still mapped by live slots are skipped -- evicting
        them frees nothing."""
        if self.prefix is None:
            return 0
        freed = 0
        # oldest stamp first; evict_chain mutates, so snapshot the order
        order = sorted(self.prefix._stamp.items(), key=lambda kv: kv[1])
        for key, _ in order:
            if freed >= n_needed:
                break
            pid = self.prefix._pages.get(key)
            if pid is None or self._ref[pid] != 1:
                continue
            pids = self.prefix.evict_chain(key)
            before = len(self._free_pages)
            self._release_pages(pids)
            freed += len(self._free_pages) - before
        return freed

    # -- invariant checking (the property-test oracle) ---------------------------

    def validate(self) -> list[str]:
        """Audit the paging invariants; returns problems ([] = healthy).

        1. refcount accounting: ref[pid] == slots mapping pid + (1 if the
           prefix cache indexes pid); free-list pages have refcount 0 and
           appear in no page table.
        2. sharing rule: a page mapped by two live slots must be indexed by
           the prefix cache (only refcounted prefix pages are shared).
        3. reachability: every row a live slot has written (its high-water
           mark, hence every ``pos >= 0`` entry) sits under a mapped page.
        4. mapped pages form a prefix of the slot's logical pages.
        """
        errs: list[str] = []
        mappers: dict[int, list[int]] = {}
        for s in range(self.n_slots):
            row = self._pt[s]
            mapped = [j for j in range(self.pages_per_slot) if row[j] >= 0]
            if mapped != list(range(len(mapped))):
                errs.append(f"slot {s}: mapped pages {mapped} not a prefix")
            for j in mapped:
                mappers.setdefault(int(row[j]), []).append(s)
            need = -(-int(self._hw[s]) // self.page_size)
            if len(mapped) < need:
                errs.append(f"slot {s}: high water {self._hw[s]} rows but only {len(mapped)} pages mapped "
                            f"(unreachable live rows)")
            if self.positions[s] >= 0 and self._hw[s] < min(self.positions[s], self.seq_len):
                errs.append(f"slot {s}: pos {self.positions[s]} beyond high water {self._hw[s]}")
        cache_pids = self.prefix.pids() if self.prefix is not None else set()
        free = set(self._free_pages)
        for pid in range(self.n_pages):
            expect = len(mappers.get(pid, ())) + (1 if pid in cache_pids else 0)
            if self._ref[pid] != expect:
                errs.append(f"page {pid}: refcount {self._ref[pid]} != {len(mappers.get(pid, ()))} mappers + "
                            f"{int(pid in cache_pids)} cache")
            if len(mappers.get(pid, ())) > 1 and pid not in cache_pids:
                errs.append(f"page {pid}: shared by slots {mappers[pid]} without a prefix-cache entry")
            if pid in free and (self._ref[pid] != 0 or pid in mappers):
                errs.append(f"page {pid}: on the free list but referenced")
        if len(free) != len(self._free_pages):
            errs.append("free list contains duplicates")
        return errs
