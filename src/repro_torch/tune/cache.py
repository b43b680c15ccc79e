"""Versioned JSON persistence for tuned block plans.

A copy of ``repro.tune.cache`` for the port.  The paper's DSE ends in Table
I: a static artefact mapping each synthesised geometry to its measured
f_max.  Our analogue is a small on-disk cache mapping a *problem* (backend,
chip, M, N, K, dtype, activation) to the block geometry that measured
fastest, so the cost of running the measurement loop is paid once per
problem shape and every later call starts from the empirical winner instead
of the kernel's shape rule.

Design constraints:

  * lookups happen on the hot dispatch path of ``kernels/*/ops.py`` -- they
    must be cheap (``plan_path``: one dict access into a table resolved once
    from the file) and must never raise (a corrupt/unreadable cache degrades
    to "no entry");
  * the file is human-readable JSON with an explicit schema version, so a
    schema change invalidates old files instead of mis-reading them;
  * the location is overridable via ``REPRO_TORCH_TUNE_CACHE`` (tests point
    it at a tmpdir), the port's own variable: the reference's
    ``REPRO_TUNE_CACHE`` leaves the port's cache as it is.

On-disk JSON schema (version 2, the reference's; a file either package
writes reads back in the other)::

    {
      "version": 2,
      "entries": {
        "<backend>|<chip>|<M>|<N>|<K>|<dtype>|<activation>|tp<TP>": {
          "bm": int, "bn": int, "bk": int,   // winning block geometry
          "mean_us": float,                  // mean measured time
          "best_us": float,                  // best-of-repeats (ranking key)
          "method": str,                     // "cuda-events" | "cpu-proxy"
                                             // | "reference-wall" | "stub"
          "repeats": int,                    // timing repeats behind mean/best
          "tuned_at": float                  // optional: unix seconds of the
                                             // measurement (0.0 = unknown)
        }, ...
      }
    }

Key fields: ``backend`` is the kernel family ("cuda-systolic" -- K1 for
bf16 / fp32, K5 for int8 / e4m3 --, "cuda-grouped" -- K4 --, "reference");
``chip`` the card the measurement targeted ("h100", ``repro_torch.core.hw``);
``dtype`` the canonical name of the input dtype ("bfloat16",
"float32", "int8", "float8_e4m3fn"); ``activation`` the fused-epilogue name
("none" when unfused); ``TP`` the tensor-parallel degree, the reference's
key segment, always 1 here (the port has no sharded matmul).
A plan's (bm, bn, bk) names one path of the backend's kernel
(``kernels/systolic/kernel.py`` ``TILES`` / ``qtiles``,
``kernels/grouped/kernel.py`` ``TILES``; the decode tile's bk is its
contraction per block).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import tempfile
import threading
import warnings
from typing import NamedTuple

SCHEMA_VERSION = 2

_ENV_VAR = "REPRO_TORCH_TUNE_CACHE"


def default_cache_path() -> pathlib.Path:
    env = os.environ.get(_ENV_VAR)
    if env:
        return pathlib.Path(env)
    xdg = os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache")
    return pathlib.Path(xdg) / "repro-torch-tune" / "plans.json"


@dataclasses.dataclass(frozen=True)
class CacheKey:
    """Identity of one tuning problem.

    ``backend`` distinguishes the kernel family the plan drives
    ("cuda-systolic", "cuda-grouped", "reference"); ``chip`` is the
    card the measurement targeted ("h100").  For the grouped kernel the
    (m, n, k) triple holds the *per-expert* (c, n, k) problem.  ``tp`` is
    the reference's tensor-parallel segment (schema v2): the single-card
    dispatch serves tp=1 entries (``plan_path``), the collective matmul's
    ring steps tp=N ones (``tuned_block``).
    """

    backend: str
    chip: str
    m: int
    n: int
    k: int
    dtype: str
    activation: str = "none"
    tp: int = 1

    def encode(self) -> str:
        return "|".join(
            [
                self.backend,
                self.chip,
                str(self.m),
                str(self.n),
                str(self.k),
                self.dtype,
                self.activation,
                f"tp{self.tp}",
            ]
        )


@dataclasses.dataclass(frozen=True)
class TunedPlan:
    """A cache entry: the winning geometry plus its measurement provenance.

    ``tuned_at`` (unix seconds; 0.0 = unknown, pre-existing entries) is
    staleness metadata: a plan's ``mean_us`` was true when the autotuner
    measured it.  It is excluded from equality -- two plans with the same
    geometry and measurement are the same plan regardless of when they were
    taken -- and optional in the JSON, so v2 cache files round-trip
    unchanged.
    """

    bm: int
    bn: int
    bk: int
    mean_us: float
    best_us: float
    method: str  # "cuda-events" | "cpu-proxy" | "reference-wall" | "stub"
    repeats: int = 1
    tuned_at: float = dataclasses.field(default=0.0, compare=False)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "TunedPlan":
        return cls(
            bm=int(d["bm"]),
            bn=int(d["bn"]),
            bk=int(d["bk"]),
            mean_us=float(d["mean_us"]),
            best_us=float(d["best_us"]),
            method=str(d["method"]),
            repeats=int(d.get("repeats", 1)),
            tuned_at=float(d.get("tuned_at", 0.0)),
        )


class PlanCache:
    """Thread-safe load/lookup/store over one JSON file."""

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = pathlib.Path(path) if path else default_cache_path()
        self._entries: dict[str, TunedPlan] | None = None
        self._lock = threading.Lock()

    # -- persistence ---------------------------------------------------------

    def _load_locked(self) -> dict[str, TunedPlan]:
        if self._entries is not None:
            return self._entries
        self._entries = self._read_file()
        return self._entries

    def _read_file(self) -> dict[str, TunedPlan]:
        entries: dict[str, TunedPlan] = {}
        try:
            raw = json.loads(self.path.read_text())
        except (OSError, ValueError):
            # Missing or unparseable cache is equivalent to an empty one;
            # the tuner will simply re-measure and rewrite it.
            return entries
        if not isinstance(raw, dict) or raw.get("version") != SCHEMA_VERSION:
            # Unknown schema version -- older (v1: no tp key segment) or
            # newer than this build -- reads as empty rather than raising
            # or mis-keying: stale winners simply re-measure.  Note the
            # first store() from this build then rewrites the file at
            # SCHEMA_VERSION, discarding the unknown-version entries --
            # acceptable because every entry is re-derivable by measuring.
            return entries
        items = raw.get("entries", {})
        if not isinstance(items, dict):
            return entries
        for key, val in items.items():
            try:
                entries[key] = TunedPlan.from_json(val)
            except (KeyError, TypeError, ValueError):
                # One hand-edited/corrupt entry must not discard the rest
                # of the cache (it used to: the whole loop sat inside one
                # try).  Skip it; that problem re-measures.
                continue
        return entries

    def _save_locked(self) -> None:
        assert self._entries is not None
        # Merge-on-write: re-read the file so entries stored by concurrent
        # processes since our lazy load survive (ours win on key collision).
        # Two simultaneous writers can still race the final os.replace --
        # last one wins for *colliding* keys only -- which is acceptable for
        # a cache whose entries are re-derivable by re-measuring.
        merged = self._read_file()
        merged.update(self._entries)
        self._entries = merged
        payload = {
            "version": SCHEMA_VERSION,
            "entries": {k: v.to_json() for k, v in sorted(self._entries.items())},
        }
        # A failed save degrades to an in-memory-only cache: this process
        # still serves the tuned plan, later processes re-measure.  Warn so
        # the silent re-tuning cost is at least visible.
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            # Atomic replace so a concurrent reader never sees a torn file.
            fd, tmp = tempfile.mkstemp(
                dir=str(self.path.parent), prefix=self.path.name, suffix=".tmp"
            )
        except OSError as e:
            warnings.warn(f"repro_torch.tune: cannot persist plan cache to {self.path}: {e}")
            return
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except OSError as e:
            warnings.warn(f"repro_torch.tune: cannot persist plan cache to {self.path}: {e}")
            try:
                os.unlink(tmp)
            except OSError:
                pass

    # -- public API ----------------------------------------------------------

    def lookup(self, key: CacheKey) -> TunedPlan | None:
        with self._lock:
            return self._load_locked().get(key.encode())

    def store(self, key: CacheKey, plan: TunedPlan) -> None:
        with self._lock:
            self._load_locked()[key.encode()] = plan
            self._save_locked()
        _forget_dispatch_table()

    def refresh(self) -> None:
        """Drop the in-memory view; next lookup re-reads the file."""
        with self._lock:
            self._entries = None
        _forget_dispatch_table()

    def __len__(self) -> int:
        with self._lock:
            return len(self._load_locked())

    def items(self) -> list[tuple[str, TunedPlan]]:
        with self._lock:
            return sorted(self._load_locked().items())


# ---------------------------------------------------------------------------
# Process-wide default cache, consulted by the kernel dispatchers.
# ---------------------------------------------------------------------------

_default: PlanCache | None = None
_default_lock = threading.Lock()


def default_cache() -> PlanCache:
    """The singleton cache at ``default_cache_path()`` (env-overridable)."""
    global _default
    with _default_lock:
        if _default is None or _default.path != default_cache_path():
            _default = PlanCache()
        return _default


def reset_default_cache() -> None:
    """Forget the singleton (tests flip REPRO_TORCH_TUNE_CACHE between
    cases; chip_smoke.py pins it before any launch)."""
    global _default
    with _default_lock:
        _default = None
    _forget_dispatch_table()


# ---------------------------------------------------------------------------
# The dispatch table: the default cache's plans that the card timed (method
# "cuda-events") for the h100 at tp 1, each resolved once to the kernel path
# its geometry names on its problem (``core.dse.kernel_path``: a tile runs it
# on 16-byte-aligned, row-major operands), keyed by (backend, m, n, k, dtype,
# activation); and beside it the card-timed plans at tp > 1, keyed by the
# same and tp, for the collective matmul (``tuned_block``).  A plan no tile
# runs there is left out; so is one measured another way (a CPU proxy, a
# stub), which says nothing of the card.  Built at the first lookup and
# dropped by every store, refresh and reset_default_cache, so the
# dispatchers pay one dict access a call.
# ---------------------------------------------------------------------------

DISPATCHED_METHOD = "cuda-events"


class TunedPath(NamedTuple):
    path: str
    k_chunk: int  # the decode tile's contraction per block; 0 otherwise
    plan: TunedPlan


_table: dict | None = None
_tp_table: dict | None = None


def _forget_dispatch_table() -> None:
    global _table, _tp_table
    _table = _tp_table = None


def _dispatch_table() -> dict:
    global _table, _tp_table
    table: dict = {}
    tp_table: dict = {}
    try:
        from repro_torch.core import dse

        for key, plan in default_cache().items():
            backend, chip, m, n, k, dtype, activation, tp = key.split("|")
            if chip != "h100" or plan.method != DISPATCHED_METHOD or backend == "reference":
                continue
            m, n, k = int(m), int(n), int(k)
            if tp != "tp1":
                tp_table[(backend, m, n, k, dtype, activation, int(tp.removeprefix("tp")))] = plan
                continue
            resolved = dse.kernel_path(plan.bm, plan.bn, plan.bk, m, n, k, dtype, backend)
            if resolved is not None:
                table[(backend, m, n, k, dtype, activation)] = TunedPath(*resolved, plan)
    except Exception:  # pragma: no cover - defensive: dispatch must not die
        table, tp_table = {}, {}
    _table, _tp_table = table, tp_table
    return table


def tuned_path(backend: str, m: int, n: int, k: int, dtype: str, activation: str = "none") -> TunedPath | None:
    """The dispatch table's entry for this problem, or None.  Never raises."""
    table = _table if _table is not None else _dispatch_table()
    return table.get((backend, m, n, k, dtype, activation))


def plan_path(backend: str, m: int, n: int, k: int, dtype: str, activation: str = "none",
              plan=None) -> tuple[str | None, int, str]:
    """(path, k_chunk, source) of ``backend``'s kernel for an (M, N, K)
    problem (K4: the per-expert (C, N, K)) of ``dtype`` operands, in the
    reference's order: the explicit ``plan``'s (a ``BlockPlan``; raises on a
    geometry no tile runs), else the tuned one (``tuned_path``), else (None,
    0, "rule"): the kernel's shape rule decides at the launch.  Whether the
    operands at hand can take the path is the launch's to check."""
    if plan is not None:
        from repro_torch.core import dse

        return (*dse.block_path(plan.bm, plan.bn, plan.bk, dtype, backend), "explicit")
    hit = tuned_path(backend, m, n, k, dtype, activation)
    return (None, 0, "rule") if hit is None else (hit.path, hit.k_chunk, "tuned")


def tuned_block(backend: str, m: int, n: int, k: int, dtype: str, activation: str = "none", tp: int = 1,
                clamp_to: tuple[int, int, int] | None = None) -> tuple[int, int, int] | None:
    """The tuned geometry of the h100's (M, N, K) problem at ``tp``, clamped
    by the reference's rule to the problem the kernel runs, or None.

    The tp-way collective matmul keys the GLOBAL problem, but each ring step
    runs a shard of it (``clamp_to``), so an over-large cached geometry is
    cut to it: each block dimension to at most the shard's, rounded up to
    the wgmma quanta (64 rows, 8 columns, 32 bytes of contraction) where the
    reference rounds to the TPU's sublanes and lanes.  Only a plan the card
    timed (``DISPATCHED_METHOD``) is served, and only if a tile of
    ``backend``'s kernel runs the clamped geometry on that problem
    (``core.dse.kernel_path``); else None, and the kernel's shape rule
    decides.  At tp = 1 the ring step is the whole problem, whose plan the
    single-card dispatch serves itself (``plan_path``): None.  Never raises."""
    try:
        from repro_torch.core import dse, hw
        from repro_torch.core.blocking import round_up

        if _tp_table is None:
            _dispatch_table()
        hit = _tp_table.get((backend, m, n, k, str(dtype), activation, tp))
        if hit is None:
            return None
        chip = hw.H100
        cm, cn, ck = clamp_to or (m, n, k)
        geo = (min(hit.bm, round_up(cm, chip.mma_m)), min(hit.bn, round_up(cn, chip.mma_n)),
               min(hit.bk, round_up(ck, chip.mma_k_bytes // hw.dtype_bytes(dtype))))
        return geo if dse.kernel_path(*geo, cm, cn, ck, dtype, backend) is not None else None
    except Exception:  # pragma: no cover - defensive: dispatch must not die
        return None
