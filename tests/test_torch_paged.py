"""The port's paged KV pool (``repro_torch.serving.paged``) against the JAX
package's on the CPU.

* **Pool parity.** One seeded random sequence of pool operations -- admit
  (lookup, attach, prepare, prefill-style row writes, register), batched
  decode-style row writes through the ``cache`` property (the ring rule on
  SWA), rewrites that copy shared pages on write, frees, reclaims, and
  ``PageExhausted`` -- drives the port's ``PagedKVPool`` and
  ``repro.serving.paged.PagedKVPool`` in lockstep.  After every operation
  the page tables, refcounts, high-water marks, free lists, prefix-cache
  entries and ``bytes_report()`` are equal, the materialised caches are
  equal bit for bit (the port keeps one dict per layer with the slot on
  axis 0, the reference stacks layers on axis 0), ``validate()`` is ``[]``
  on both, and the null page still holds 0 / -1.  Layouts: GQA
  (internlm2), the SWA ring (h2o-danube, decode writes wrapping into shared
  pages), MLA latents (minicpm3, 30 rows on pages of 8: the gather drops the
  last page's tail) and kv8, whose int8 values and per-page scales equal
  JAX's bit for bit.  Row contents are a function of the token at that
  position, the property real prefix reuse rests on.
* **The reference's pool tests** (``tests/test_paged.py``), one for one,
  against the port's pool through the same kind of stub model.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models.registry import get_model as jax_get_model
from repro.serving.paged import PagedKVPool as JaxPagedKVPool
from repro.serving.paged import PageExhausted as JaxPageExhausted
from repro_torch import configs
from repro_torch.models.registry import get_model
from repro_torch.serving import ContinuousScheduler, KVPool, ServeConfig, ServeEngine
from repro_torch.serving.paged import PagedKVPool, PageExhausted

CPU = "cpu"

# -- pool parity with the JAX pool ----------------------------------------------------

# layout -> (arch, max_len, page size, kv8); three slots of four pages over eight
LAYOUTS = {
    "gqa": ("internlm2-1.8b", 32, 8, False),
    "swa": ("h2o-danube-3-4b", 48, 8, False),  # a 32-row ring
    "mla": ("minicpm3-4b", 30, 8, False),  # 4 pages of 8 hold 32 > 30 rows
    "kv8": ("internlm2-1.8b", 32, 8, True),
}
SLOTS, PAGES, VOCAB, STEPS = 3, 8, 3, 80


class _Pair:
    """The two pools driven in lockstep, with the token-valued row table."""

    def __init__(self, arch, max_len, page, kv8, seed):
        jcfg = dataclasses.replace(jax_get_smoke(arch), dtype="float32")
        tcfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32")
        kw = dict(quantize_kv_cache=kv8, page_size=page, n_pages=PAGES, prefix_cache=True)
        self.j = JaxPagedKVPool(jax_get_model(jcfg), SLOTS, max_len, **kw)
        self.t = PagedKVPool(get_model(tcfg), SLOTS, max_len, device=CPU, **kw)
        self.rng = np.random.default_rng(seed)
        layer = self.t.phys["layers"][0]
        self.names = [n for n in layer if n != "pos"]
        self.n_layers = tcfg.n_layers
        # row value of token t at layer l: table[name][t, l] (scaled per
        # layer so kv8's absmax scales differ across pages and layers)
        self.table = {n: (self.rng.standard_normal((VOCAB, self.n_layers, *layer[n].shape[2:]))
                          * self.rng.uniform(0.5, 4.0, (1, self.n_layers) + (1,) * (layer[n].ndim - 2))
                          ).astype(np.float32) for n in self.names}
        # two "system prompts" most prompts start with, so prefixes are shared
        self.system = self.rng.integers(0, VOCAB, (2, max_len)).astype(np.int32)
        self.tokens: dict[int, dict[int, int]] = {}  # slot -> {logical row: token}
        self.wrapped = 0  # decode writes past the end of the ring
        self.exhausted = 0  # operations both pools refused with PageExhausted

    def both(self, fn):
        """Run fn(pool, exhausted_type) on the JAX pool, then the port's: the
        results, and whether each raised PageExhausted, must agree."""
        out = []
        for pool, exc in ((self.j, JaxPageExhausted), (self.t, PageExhausted)):
            try:
                out.append(("ok", fn(pool, exc)))
            except exc:
                out.append(("exhausted", None))
        assert out[0][0] == out[1][0], out
        self.exhausted += out[0][0] == "exhausted"
        return out[0]

    # row writes through the public surface -----------------------------------

    def _stamp_view(self, view, is_jax, b, rows):
        """Write {row: (token, pos)} of batch row b into a materialised view."""
        for name in self.names:
            for r, (tok, _) in rows.items():
                if is_jax:
                    view[name][:, b, r] = self.table[name][tok]
                else:
                    for l in range(self.n_layers):
                        view[l][name][b, r] = torch.from_numpy(self.table[name][tok, l])
        for r, (_, p) in rows.items():
            if is_jax:
                view["pos"][:, b, r] = p
            else:
                for l in range(self.n_layers):
                    view[l]["pos"][b, r] = p

    def write_slot(self, slot, rows, next_pos):
        def f(pool, _):
            view = pool.gather_slot(slot)
            if pool is self.j:
                la = {k: np.asarray(v).copy() for k, v in view["layers"].items()}
                self._stamp_view(la, True, 0, rows)
                pool.write_slot(slot, {"layers": {k: jnp.asarray(v) for k, v in la.items()}}, next_pos=next_pos)
            else:
                self._stamp_view(view["layers"], False, 0, rows)
                pool.write_slot(slot, view, next_pos=next_pos)

        self.both(f)

    def write_cache(self, rows_by_slot):
        def f(pool, _):
            cache = pool.cache
            if pool is self.j:
                la = {k: np.asarray(v).copy() for k, v in cache["layers"].items()}
                for slot, rows in rows_by_slot.items():
                    self._stamp_view(la, True, slot, rows)
                pool.cache = {"layers": {k: jnp.asarray(v) for k, v in la.items()}}
            else:
                for slot, rows in rows_by_slot.items():
                    self._stamp_view(cache["layers"], False, slot, rows)
                pool.cache = cache

        self.both(f)

    # the operations -----------------------------------------------------------

    def admit(self):
        slot = self.both(lambda p, _: p.alloc())[1]
        if slot is None:
            return
        seq = self.t.seq_len
        n = int(self.rng.integers(2, seq - 1))
        toks = self.rng.integers(0, VOCAB, n).astype(np.int32)
        shared = max(0, n - int(self.rng.integers(0, 10)))
        toks[:shared] = self.system[int(self.rng.integers(2)), :shared]
        hit, pids = self.both(lambda p, _: p.lookup_prefix(toks))[1]
        if hit:
            self.both(lambda p, _: p.attach_prefix(slot, pids))
        if self.both(lambda p, _: p.prepare_write(slot, hit, n))[0] == "exhausted":
            self.both(lambda p, _: p.free(slot))
            return
        self.write_slot(slot, {r: (int(toks[r]), r) for r in range(hit, n)}, next_pos=n)
        self.tokens[slot] = {r: int(toks[r]) for r in range(n)}
        self.both(lambda p, _: p.register_prefix(slot, toks, n))

    def decode(self):
        live = sorted(self.tokens)
        if not live:
            return
        rows = {}
        for slot in live:
            idx = self.t.decode_write_index(slot)
            assert idx == self.j.decode_write_index(slot)
            if self.both(lambda p, _: p.prepare_write(slot, idx, idx + 1))[0] == "exhausted":
                return
            tok = int(self.rng.integers(0, VOCAB))
            rows[slot] = {idx: (tok, int(self.t.positions[slot]))}
            self.wrapped += int(self.t.positions[slot]) >= self.t.seq_len
        self.write_cache(rows)
        self.both(lambda p, _: p.advance(live))
        for slot, r in rows.items():
            (idx, (tok, _)), = r.items()
            self.tokens[slot][idx] = tok

    def rewrite(self):
        """Rewrite a written range of a live slot with its own tokens:
        prepare_write copies any shared page in the range first."""
        if not self.tokens:
            return
        slot = int(self.rng.choice(sorted(self.tokens)))
        hw = int(self.t._hw[slot])
        start = int(self.rng.integers(0, hw))
        end = min(hw, start + int(self.rng.integers(1, 6)))
        if self.both(lambda p, _: p.prepare_write(slot, start, end))[0] == "exhausted":
            return
        view_pos = self.t.gather_slot(slot)["layers"][0]["pos"][0]
        rows = {r: (self.tokens[slot][r], int(view_pos[r])) for r in range(start, end)}
        self.write_slot(slot, rows, next_pos=None)

    def free(self):
        if not self.tokens:
            return
        slot = int(self.rng.choice(sorted(self.tokens)))
        self.both(lambda p, _: p.free(slot))
        del self.tokens[slot]

    def reclaim(self):
        n = int(self.rng.integers(1, 4))
        self.both(lambda p, _: p.reclaim_prefix_pages(n))

    # the comparison -----------------------------------------------------------

    def check(self, step):
        j, t = self.j, self.t
        for name in ("_pt", "_ref", "_hw", "positions"):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=f"step {step}: {name}")
        assert t._free_pages == j._free_pages and t._free_slots == j._free_slots, step
        assert t.prefix._pages == j.prefix._pages and t.prefix._stamp == j.prefix._stamp, step
        assert (t.prefix.hits, t.prefix.misses) == (j.prefix.hits, j.prefix.misses), step
        assert t.bytes_report() == j.bytes_report() and t.page_bytes() == j.page_bytes(), step
        assert t.validate() == [] and j.validate() == [], step
        tc, jc = t.cache["layers"], j.cache["layers"]
        for name in (*self.names, "pos"):
            want = np.asarray(jc[name])
            for l in range(self.n_layers):
                np.testing.assert_array_equal(tc[l][name].numpy(), want[l], err_msg=f"step {step}: {name}[{l}]")
        for l, layer in enumerate(t._resident()["layers"]):
            assert (layer["pos"][-1] == -1).all(), step  # the null page
            for name in self.names:
                if t.quantize_kv:
                    for part in ("qv", "qs"):
                        np.testing.assert_array_equal(layer[name][part].numpy(),
                                                      np.asarray(j._qphys["layers"][name][part][l]),
                                                      err_msg=f"step {step}: kv8 {name}.{part}[{l}]")
                    assert (layer[name]["qv"][-1] == 0).all() and (layer[name]["qs"][-1] == 1.0).all()
                else:
                    assert (layer[name][-1] == 0).all(), step


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_pool_matches_jax_after_every_operation(layout):
    pair = _Pair(*LAYOUTS[layout], seed=101)
    ops = [pair.admit, pair.admit, pair.decode, pair.decode, pair.rewrite, pair.free, pair.free, pair.reclaim]
    if layout == "swa":
        ops += [pair.decode] * 6  # long enough lives to wrap the ring
    seen = set()
    for step in range(STEPS):
        op = ops[int(pair.rng.integers(len(ops)))]
        op()
        seen.add(op.__name__)
        pair.check(step)
    # the walk reached every operation, an exhausted arena, prefix hits and
    # (on the ring) writes past the window
    assert seen == {"admit", "decode", "rewrite", "free", "reclaim"}
    assert pair.exhausted > 0 and pair.t.prefix.hits > 0
    if layout == "swa":
        assert pair.wrapped > 0


def test_pool_refuses_what_jax_refuses():
    """Argument checks agree: a chain longer than the table row, a page id
    out of range or NaN-shaped, a double free, a write to an invalid slot,
    an arena smaller than one slot."""
    pair = _Pair(*LAYOUTS["gqa"], seed=3)
    for pool in (pair.j, pair.t):
        slot = pool.alloc()
        for pids in ([0] * (pool.pages_per_slot + 1), [PAGES], [float("nan")], [1.5]):
            with pytest.raises(ValueError):
                pool.attach_prefix(slot, pids)
        assert not np.any(pool._pt[slot] >= 0) and not pool._ref.any()
        with pytest.raises(ValueError):
            pool.prepare_write(SLOTS, 0, 1)
        pool.free(slot)
        with pytest.raises(ValueError):
            pool.free(slot)
    with pytest.raises(ValueError, match="cannot hold even one full slot"):
        PagedKVPool(pair.t.model, 2, 32, page_size=8, n_pages=3, device=CPU)


# -- the reference's pool tests (tests/test_paged.py), one for one --------------------

PAGE = 8
SEQ = 32


class _StubModel:
    """Minimal carrier of the ``init_cache`` contract the pools consume: two
    layers of {k, v, pos} with a tiny head dim, one dict per layer."""

    cfg = types.SimpleNamespace(dtype="float32")

    def init_cache(self, batch, max_len, dtype, device):
        return {"layers": [{"k": torch.zeros((batch, max_len, 4), dtype=dtype, device=device),
                            "v": torch.zeros((batch, max_len, 4), dtype=dtype, device=device),
                            "pos": torch.full((batch, max_len), -1, dtype=torch.int32, device=device)}
                           for _ in range(2)]}


def _pool(n_slots=3, n_pages=None, prefix=True, page=PAGE, seq=SEQ):
    return PagedKVPool(_StubModel(), n_slots, seq, page_size=page, n_pages=n_pages, prefix_cache=prefix,
                       device=CPU)


def _write_rows(pool, slot, start, end, values, next_pos=None):
    """Write rows [start, end) through the public surface: prepare pages,
    stamp the gathered view (k/v rows carry ``values``, pos rows their
    absolute positions), scatter back."""
    pool.prepare_write(slot, start, end)
    view = pool.gather_slot(slot)
    vals = torch.as_tensor(np.asarray(values, np.float32)).reshape(end - start, 1)
    for layer in view["layers"]:
        layer["k"][0, start:end] = vals
        layer["v"][0, start:end] = vals + 0.5
        layer["pos"][0, start:end] = torch.arange(start, end, dtype=torch.int32)
    pool.write_slot(slot, view, next_pos=end if next_pos is None else next_pos)


def _rows(pool, slot):
    """(k_row_value, pos) per row of the slot's gathered view (layer 0)."""
    layer = pool.gather_slot(slot)["layers"][0]
    return layer["k"][0, :, 0].numpy(), layer["pos"][0].numpy()


def test_arena_shape_and_null_gather():
    pool = _pool()
    assert pool.pages_per_slot == SEQ // PAGE
    assert pool.phys["layers"][0]["k"].shape == (pool.n_pages + 1, PAGE, 4)
    kv, pos = _rows(pool, 0)  # an unmapped slot gathers pure null content
    assert (kv == 0).all() and (pos == -1).all()
    assert pool.validate() == []


def test_write_gather_no_cross_talk():
    pool = _pool()
    a, b = pool.alloc(), pool.alloc()
    _write_rows(pool, a, 0, 10, np.full(10, 7.0))
    _write_rows(pool, b, 0, 5, np.full(5, 9.0))
    ka, pa = _rows(pool, a)
    kb, pb = _rows(pool, b)
    assert (ka[:10] == 7.0).all() and (pa[:10] == np.arange(10)).all()
    assert (kb[:5] == 9.0).all() and (pb[5:] == -1).all()
    assert pool.pages_in_use == 2 + 1  # ceil(10/8) + ceil(5/8)
    assert pool.validate() == []


def test_pages_allocated_on_demand_and_freed():
    pool = _pool(prefix=False)
    s = pool.alloc()
    _write_rows(pool, s, 0, PAGE, np.zeros(PAGE))
    assert pool.pages_in_use == 1
    _write_rows(pool, s, PAGE, PAGE + 1, [1.0])  # decode-style append
    assert pool.pages_in_use == 2
    pool.free(s)
    assert pool.pages_in_use == 0 and pool.pages_free == pool.n_pages
    # freed pages were blanked: reuse (LIFO -> same slot) shows null
    # content, not stale rows
    s2 = pool.alloc()
    assert s2 == s
    kv, pos = _rows(pool, s2)
    assert (kv == 0).all() and (pos == -1).all()
    assert pool.validate() == []
    pool.free(s2)
    with pytest.raises(ValueError):
        pool.free(s2)  # double free of a free slot


def test_prefix_attach_shares_and_cow_isolates():
    pool = _pool()
    tokens = np.arange(100, 100 + 2 * PAGE)  # two full pages of tokens
    a = pool.alloc()
    _write_rows(pool, a, 0, 2 * PAGE, tokens.astype(np.float32))
    assert pool.register_prefix(a, tokens, 2 * PAGE) == 2  # both full pages
    # lookup is capped one page short of the prompt: at least one token must
    # go through a real forward pass for the last-position logits
    hit, pids = pool.lookup_prefix(tokens)
    assert hit == PAGE and len(pids) == 1
    b = pool.alloc()
    pool.attach_prefix(b, pids)
    kb, pb = _rows(pool, b)
    assert (kb[:PAGE] == tokens[:PAGE]).all()  # shared page visible in b
    assert pool._ref[pids[0]] == 3  # slot a + slot b + prefix cache
    assert pool.validate() == []
    # a write overlapping the shared page copies it first: a is untouched
    pool.prepare_write(b, PAGE - 2, PAGE + 2)
    assert pool._ref[pids[0]] == 2  # b now owns a private copy
    _write_rows(pool, b, PAGE - 2, PAGE + 2, np.full(4, -7.0))
    ka, _ = _rows(pool, a)
    assert (ka[: 2 * PAGE] == tokens).all()
    kb, _ = _rows(pool, b)
    assert (kb[PAGE - 2 : PAGE + 2] == -7.0).all()
    assert pool.validate() == []


def test_free_keeps_prefix_pages_until_reclaim():
    pool = _pool()
    tokens = np.arange(2 * PAGE)
    a = pool.alloc()
    _write_rows(pool, a, 0, 2 * PAGE, tokens.astype(np.float32))
    pool.register_prefix(a, tokens, 2 * PAGE)
    pool.free(a)
    assert pool.pages_in_use == 2  # both registered pages survive the free on their cache refs
    hit, pids = pool.lookup_prefix(tokens)
    assert hit == PAGE
    assert pool.validate() == []
    # LRU reclaim erodes the chain leaf-first (lookup only refreshed the
    # root's stamp), so each call frees exactly what it needs
    assert pool.reclaim_prefix_pages(1) == 1
    assert pool.pages_in_use == 1
    assert pool.validate() == []
    assert pool.reclaim_prefix_pages(1) == 1
    assert pool.pages_in_use == 0
    assert pool.lookup_prefix(tokens) == (0, [])
    assert pool.validate() == []


def test_reclaim_skips_pages_mapped_by_live_slots():
    pool = _pool()
    tokens = np.arange(2 * PAGE)
    a = pool.alloc()
    _write_rows(pool, a, 0, 2 * PAGE, tokens.astype(np.float32))
    pool.register_prefix(a, tokens, 2 * PAGE)
    # a still maps the cached page: evicting the entry would free nothing
    assert pool.reclaim_prefix_pages(4) == 0
    assert pool.lookup_prefix(tokens)[0] == PAGE
    assert pool.validate() == []


def test_page_exhausted_and_state_unchanged():
    pool = _pool(n_slots=2, n_pages=SEQ // PAGE, prefix=False)
    a = pool.alloc()
    _write_rows(pool, a, 0, SEQ, np.zeros(SEQ))  # consumes every page
    b = pool.alloc()
    with pytest.raises(PageExhausted):
        pool.prepare_write(b, 0, PAGE)
    assert not np.any(pool._pt[b] >= 0)  # b still unmapped
    assert pool.validate() == []
    pool.free(a)
    pool.prepare_write(b, 0, PAGE)  # now succeeds
    assert pool.validate() == []


def test_paged_disabled_for_state_families():
    """The scheduler's gating: a family whose caches have no sequence axis
    gets the slot pool and no prefix cache (the port does not build such a
    model yet, so the engine here carries only what the constructor reads),
    and the pool refuses a cache tensor outside a pos-masked group."""
    cfg = dataclasses.replace(configs.get_smoke("internlm2-1.8b"), dtype="float32")
    model = get_model(cfg)
    eng = types.SimpleNamespace(cfg=dataclasses.replace(cfg, family="ssm"), model=model,
                                scfg=ServeConfig(max_len=16, batch=2), device=torch.device(CPU),
                                supports_chunked_prefill=True, attn_cache_len=lambda: 16)
    with pytest.warns(UserWarning) as rec:
        sched = ContinuousScheduler(eng, paged=True, prefix_cache=True)
    msgs = " ".join(str(w.message) for w in rec)
    assert "paged KV disabled" in msgs
    assert "prefix_cache requires the paged pool" in msgs
    assert not sched.paged
    assert isinstance(sched.pool, KVPool)

    class _StateModel(_StubModel):
        def init_cache(self, batch, max_len, dtype, device):
            cache = super().init_cache(batch, max_len, dtype, device)
            cache["state"] = torch.zeros((batch, 4), dtype=dtype, device=device)
            return cache

    with pytest.raises(ValueError, match="state-cache families"):
        PagedKVPool(_StateModel(), 2, SEQ, device=CPU)


def test_prefix_cache_off_for_a_frontend_that_cannot_prefill_a_suffix():
    cfg = dataclasses.replace(configs.get_smoke("internlm2-1.8b"), dtype="float32")
    model = get_model(cfg)
    eng = ServeEngine(model, model.init(0, CPU), ServeConfig(max_len=16, batch=2), device=CPU)
    eng.cfg = dataclasses.replace(cfg, frontend="vit")  # what supports_chunked_prefill reads
    with pytest.warns(UserWarning, match="cannot prefill a prompt suffix"):
        sched = ContinuousScheduler(eng, paged=True, prefix_cache=True)
    assert sched.paged and sched.pool.prefix is None


# -- bytes accounting ---------------------------------------------------------------------


def test_unpaged_bytes_report_half_filled_slot():
    """``bytes_resident`` reports the full reserved stripe; the report also
    exposes the live bytes under the pos mask."""
    pool = KVPool(_StubModel(), n_slots=2, max_len=SEQ, device=CPU)
    s = pool.alloc()
    pool.write_slot(s, pool.gather_slot(s), next_pos=SEQ // 2)
    rep = pool.bytes_report()
    # reserved: 2 slots * (k + v: 2*32*4 fp32 each = 1024 B, pos: 2*32 int32)
    assert rep["reserved"] == pool.bytes_resident() == 2 * (2 * 1024 + 256)
    # live: one slot holding 16 of 2*32 slot-rows of the stripe -> 1/4
    assert rep["live"] == rep["reserved"] // 4 == 1152
    pool.free(s)
    assert pool.bytes_report()["live"] == 0


def test_paged_bytes_report_tracks_pages_not_slots():
    pool = _pool(n_slots=3, prefix=False)
    assert pool.bytes_report() == {"reserved": 0, "live": 0}
    s = pool.alloc()
    _write_rows(pool, s, 0, PAGE + 2, np.zeros(PAGE + 2))
    rep = pool.bytes_report()
    assert rep["reserved"] == 2 * pool.page_bytes()
    assert rep["live"] == (PAGE + 2) * pool.page_bytes() // PAGE  # top page holds 2 of 8 written rows
    assert rep["live"] < rep["reserved"] < KVPool(_StubModel(), 3, SEQ, device=CPU).bytes_resident()


@pytest.mark.parametrize("kv8", [False, True])
def test_page_bytes_at_full_width(kv8):
    """One page of full-width internlm2-1.8b: 24 layers x 16 rows x (K and V
    at 8 heads x 128, bf16, and an int32 position) = 1,574,400 bytes; under
    kv8 int8 values and one fp32 scale per K/V head and page."""
    model = get_model(configs.get_config("internlm2-1.8b"))
    pool = PagedKVPool(model, 1, 16, quantize_kv_cache=kv8, page_size=16, device=CPU)
    want = 24 * (16 * (2 * 8 * 128 * 2 + 4)) if not kv8 else 24 * (16 * (2 * 8 * 128 + 4) + 2 * 8 * 4)
    assert pool.page_bytes() == want
    assert not kv8 or want == 24 * (16 * 2052 + 64)
    if not kv8:
        assert want == 1_574_400


# -- deterministic fuzz against a host shadow ---------------------------------------------


def test_seeded_fuzz_random_walk_against_shadow():
    """300 random admit / extend / free / attach / reclaim operations against
    a host shadow.  After every operation the pool's invariants validate;
    every 20 the gathered rows of every live slot equal the shadow exactly.
    Row contents are a function of the *token* at that position, so a prefix
    attach is indistinguishable from recomputing the rows -- any divergence
    is page-table corruption."""
    rng = np.random.default_rng(42)
    page, seq, vocab = 4, 24, 3
    pool = PagedKVPool(_StubModel(), 4, seq, page_size=page, n_pages=20, prefix_cache=True, device=CPU)
    shadow: dict[int, np.ndarray] = {}  # slot -> (n,) token-valued rows

    def admit():
        slot = pool.alloc()
        if slot is None:
            return
        n = int(rng.integers(2, seq - 4))
        tokens = rng.integers(0, vocab, n).astype(np.int64)
        hit, pids = pool.lookup_prefix(tokens)
        if hit:
            pool.attach_prefix(slot, pids)
        try:
            _write_rows(pool, slot, hit, n, tokens[hit:].astype(np.float32))
        except PageExhausted:
            pool.free(slot)
            return
        shadow[slot] = tokens.astype(np.float32)
        pool.register_prefix(slot, tokens, n)

    def extend():
        if not shadow:
            return
        slot = int(rng.choice(sorted(shadow)))
        n = len(shadow[slot])
        if n >= seq:
            return
        tok = float(rng.integers(0, vocab))
        try:
            _write_rows(pool, slot, n, n + 1, [tok])
        except PageExhausted:
            return
        shadow[slot] = np.append(shadow[slot], np.float32(tok))

    def free():
        if not shadow:
            return
        slot = int(rng.choice(sorted(shadow)))
        pool.free(slot)
        del shadow[slot]

    def reclaim():
        pool.reclaim_prefix_pages(int(rng.integers(1, 4)))

    ops = [admit, admit, extend, extend, extend, free, reclaim]
    for step in range(300):
        ops[int(rng.integers(len(ops)))]()
        errs = pool.validate()
        assert errs == [], f"step {step}: {errs}"
        if step % 20 == 0:
            for slot, want in shadow.items():
                kv, pos = _rows(pool, slot)
                n = len(want)
                np.testing.assert_array_equal(kv[:n], want, err_msg=f"slot {slot}")
                assert (pos[:n] == np.arange(n)).all()
                assert (pos[n:] == -1).all()
    for slot in list(shadow):
        pool.free(slot)
    pool.reclaim_prefix_pages(pool.n_pages)
    assert pool.pages_in_use == 0 and pool.validate() == []


def test_gathered_cache_is_a_contiguous_copy():
    """The materialised cache has the slot pool's shape and layout (also
    where the last page overhangs seq_len: 30 rows on pages of 8), and a
    write into it reaches the arena only when assigned back."""
    pool = _pool(n_slots=2, seq=30)
    assert pool.pages_per_slot * PAGE == 32
    s = pool.alloc()
    _write_rows(pool, s, 0, 12, np.arange(12))
    stripe = KVPool(_StubModel(), 2, 30, device=CPU).cache
    cache = pool.cache
    for got, want in zip(cache["layers"], stripe["layers"]):
        for name in ("k", "v", "pos"):
            assert got[name].shape == want[name].shape and got[name].is_contiguous()
    cache["layers"][0]["k"][s, 0] = 99.0
    assert _rows(pool, s)[0][0] == 0.0
    pool.cache = cache
    assert _rows(pool, s)[0][0] == 99.0
    assert (pool.phys["layers"][0]["k"][-1] == 0).all()  # the null page untouched
