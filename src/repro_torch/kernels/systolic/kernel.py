"""ctypes bindings of the hand-written CUDA systolic GEMMs.

``systolic_matmul_call`` (``csrc/systolic_mmm.cu``) is the counterpart of
``repro.kernels.systolic.kernel.systolic_matmul_call``: one launch computes
``act(A @ B [+ bias])`` with an fp32 accumulator, on the path the caller
names (a tuned plan's, ``kernels/systolic/ops.py``) or else the one that
``gemm_path`` picks by shape, dtype and alignment.  ``quant_systolic_matmul_call``
(``csrc/systolic_qmm.cu``) is the block-scaled int8 / fp8 GEMM, likewise.
Both kernels mask ragged edges themselves, so shapes need not divide any
block.  ``TILES`` / ``QTILES`` name each path's (bm, bn, bk): the geometry
that a tuned plan (``tune/cache.py``) stores, one path per geometry.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from repro_torch.core import hw
from repro_torch.core.blocking import BlockPlan
from repro_torch.kernels import _build
from repro_torch.kernels.systolic.ref import ACTIVATIONS

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ACTIVATION_CODES = {name: i for i, name in enumerate(ACTIVATIONS)}

# The systolic GEMM's paths, numbered as in csrc/systolic_mmm.cu:
#   fma            fp32 operands, CUDA-core FMA (the reference's full fp32);
#   decode         bf16, M <= 16: the WMMA 16-row tile, contraction split across blocks;
#   wmma           bf16 shapes TMA cannot take: the WMMA 128x128 tile;
#   wgmma_128x128  bf16 prefill: TMA ring + wgmma, two consumer warpgroups;
#   wgmma_64x128   the same with one consumer warpgroup;
#   wgmma_128x256  two consumer warpgroups of 64 x 256.
#   fma_kmajor, decode_kmajor, wmma_kmajor
#                  the fma, decode and wmma tiles reading B K-major (the
#                  transpose of an (N, K) row-major matrix: a tied head's
#                  embedding table), with no transposed copy.
# Of the wgmma tiles the widest whose grid has a tile for at least half the
# SMs is taken (the 64x128 tile when none has): a wider tile re-reads fewer
# operand bytes per product, and on the H100 it was the fastest of the three
# at every served prefill shape so chosen (measured on the H100, PERF.md).
PATHS = ("fma", "decode", "wmma", "wgmma_128x128", "wgmma_64x128", "wgmma_128x256",
         "fma_kmajor", "decode_kmajor", "wmma_kmajor")
WGMMA_TILES = (("wgmma_128x256", 128, 256), ("wgmma_128x128", 128, 128), ("wgmma_64x128", 64, 128))
DECODE_MAX_M = 16  # csrc/common.cuh D_BM
DECODE_BN, DECODE_BK = 64, 64  # csrc/common.cuh D_BN, D_BK

# Each path's tile as (bm, bn, bk), one path per geometry; a K-major path
# runs its row-major twin's tile.  The decode tile's bk is its contraction
# per block (``k_chunk``, a multiple of DECODE_BK; ``plan_split``'s when not
# given), so its geometry is (16, 64, k_chunk).
TILES = {
    "fma": (64, 64, 16),  # csrc/gemm.cuh F_BM, F_BN, F_BK
    "decode": (DECODE_MAX_M, DECODE_BN, DECODE_BK),
    "wmma": (128, 128, 32),
    "wgmma_128x128": (128, 128, 64),  # csrc/wgmma_gemm.cuh: 64-deep k stages
    "wgmma_64x128": (64, 128, 64),
    "wgmma_128x256": (128, 256, 64),
}

# Kernel launches made by this process, in all, by (M, K, N), by path and
# by (M, K, N, path, k_chunk, source, aligned), the source being where the
# path came from: "explicit" (a caller's plan), "tuned" (the plan cache),
# "rule" (``gemm_path``) or "tuned_refused" (the rule's path where the
# operands at hand could not take the cached one), ``aligned`` the operands'
# base alignment the path was settled on.  Read and reset by chip_smoke.py.
launches = 0
launches_by_shape: collections.Counter = collections.Counter()
launches_by_path: collections.Counter = collections.Counter()
launches_by_plan: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


# Argument types of each library's C entry point, named as the library.
_ARGTYPES = {
    "systolic_mmm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _LL, _P],
    "systolic_qmm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _LL, _P],
    "grouped_mmm": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P],  # bound in kernels/grouped/kernel.py
}


@functools.cache
def _entry(name: str):
    """The loaded library ``name`` and its C entry point (built on first call)."""
    lib = _build.library(name)
    fn = getattr(lib, name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = _I
    lib.split_workspace.argtypes = [_I, _I, _I, _I, _I]
    lib.split_workspace.restype = _LL
    return lib, fn


@functools.cache
def _workspace_bytes(name: str, m: int, n: int, k: int, splittable: bool, k_chunk: int,
                     device_index: int | None) -> int:
    """fp32 scratch bytes of the split-K partials (``csrc/common.cuh``
    ``plan_split``); depends on the shape, the contraction per block and the
    card's SM count, so it is asked once per shape, chunk and card."""
    return _entry(name)[0].split_workspace(m, n, k, int(splittable), k_chunk)


def _workspace(name: str, device: torch.device, m: int, n: int, k: int, splittable: bool, k_chunk: int = 0):
    """(scratch tensor or None, its bytes) for one launch of library ``name``."""
    nbytes = _workspace_bytes(name, m, n, k, splittable, k_chunk, device.index)
    ws = torch.empty(nbytes // 4, dtype=torch.float32, device=device) if nbytes else None
    return ws, nbytes


# Threads per block of each path's tile (csrc/gemm.cuh: 32 per warp; the
# wgmma tiles: 128 per consumer warpgroup and the producer's).
THREADS = {"fma": 256, "decode": 128, "wmma": 256, "wgmma_128x128": 384, "wgmma_64x128": 256, "wgmma_128x256": 384}


def launch_of(path: str, m: int, n: int, k: int, sms: int, k_chunk: int = 0) -> _build.Launch:
    """The launch ``path`` runs an (M, K) @ (K, N) product with on a card of
    ``sms`` SMs: a block per (bm, bn) tile, the decode tile's split-K slices
    on the grid's z, the wgmma tiles' ring as dynamic shared memory
    (``BlockPlan.smem_bytes``).  The Python accounting that ``launch_query``
    (the binary's own) is held to."""
    base = path.removesuffix("_kmajor")
    bm, bn, bk = TILES[base]
    splits, chunk = plan_split(m, n, k, sms, k_chunk) if base == "decode" else (1, k)
    dyn = BlockPlan(m, n, k, bm, bn, bk).smem_bytes() if base.startswith("wgmma") else 0
    return _build.Launch((-(-n // bn), -(-m // bm), splits), THREADS[base], dyn, splits, chunk if splits > 1 else 0)


def launch_query(path: str, m: int, n: int, k: int, dtype: torch.dtype, out_dtype: torch.dtype,
                 k_chunk: int = 0) -> tuple[_build.Launch, _build.Compiled]:
    """What the binary launches for ``path`` at (M, N, K) with these dtypes
    and ``k_chunk``, and the compiled kernel's attributes
    (``systolic_mmm_query``; needs the card)."""
    return _build.query(_entry("systolic_mmm")[0], "systolic_mmm_query", m, n, k, DTYPE_CODES[dtype],
                        DTYPE_CODES[out_dtype], PATHS.index(path), k_chunk)


def plan_split(m: int, n: int, k: int, sms: int, k_chunk: int = 0) -> tuple[int, int]:
    """(splits, contraction per split) of the decode tile on a card of
    ``sms`` SMs: ``csrc/common.cuh``'s ``plan_split``, the same rule."""
    if m > DECODE_MAX_M or k <= DECODE_BK:
        return 1, k
    if k_chunk > 0:
        return (1, k) if k_chunk >= k else (-(-k // k_chunk), k_chunk)
    col_tiles = -(-n // DECODE_BN)
    k_tiles = -(-k // DECODE_BK)
    splits = min(-(-4 * sms // col_tiles), k_tiles)
    if splits <= 1:
        return 1, k
    per = -(-k_tiles // splits)
    return -(-k_tiles // per), per * DECODE_BK


def block_of(path: str, m: int, n: int, k: int, sms: int, k_chunk: int = 0) -> tuple[int, int, int]:
    """The (bm, bn, bk) that ``path`` runs an (M, K) @ (K, N) product on:
    its tile, the decode tile's bk its contraction per block (K rounded up to
    the k stage when the contraction is not split)."""
    base = path.removesuffix("_kmajor")
    if base == "decode":
        splits, chunk = plan_split(m, n, k, sms, k_chunk)
        return DECODE_MAX_M, DECODE_BN, chunk if splits > 1 else -(-max(k, 1) // DECODE_BK) * DECODE_BK
    return TILES[base]


def path_of_block(bm: int, bn: int, bk: int) -> tuple[str, int]:
    """(path, k_chunk) that a (bm, bn, bk) geometry names; raises on a
    geometry no tile runs."""
    if (bm, bn) == TILES["decode"][:2] and bk > 0 and bk % DECODE_BK == 0:
        return "decode", bk
    for path, tile in TILES.items():
        if tile == (bm, bn, bk) and path != "decode":
            return path, 0
    raise ValueError(f"no systolic tile runs the block ({bm}, {bn}, {bk}); tiles: {TILES}")


def path_refusal(path: str, m: int, n: int, k: int, dtype: torch.dtype, aligned: bool, k_major: bool = False,
                 k_chunk: int = 0) -> str | None:
    """Why ``path`` cannot take these operands (None: it can): the kernel's
    own checks (csrc/systolic_mmm.cu), made before a launch."""
    if path not in PATHS:
        return f"unknown path {path!r}; paths: {PATHS}"
    base = path.removesuffix("_kmajor")
    if (dtype == torch.float32) != (base == "fma"):
        return f"path {path} does not take {dtype} operands"
    if path.endswith("_kmajor") != k_major:
        return f"path {path} reads B {'row-major' if k_major else 'K-major'}; B is the other"
    if base == "decode" and m > DECODE_MAX_M:
        return f"the decode tile takes M <= {DECODE_MAX_M}, not {m}"
    if base.startswith("wgmma") and (k == 0 or k % 8 or n % 8 or not aligned):
        return f"path {path} needs K and N multiples of 8 and 16-byte-aligned bases (TMA); got K={k}, N={n}, " \
               f"aligned={aligned}"
    if k_chunk and (base != "decode" or k_chunk < 0 or k_chunk % DECODE_BK):
        return f"k_chunk {k_chunk} is for the decode tile only, a multiple of {DECODE_BK}"
    return None


def gemm_path(m: int, n: int, k: int, dtype: torch.dtype, aligned: bool, sms: int, k_major: bool = False) -> str:
    """The systolic GEMM's path for an (M, K) @ (K, N) product of ``dtype``
    operands whose bases are 16-byte aligned (``aligned``) on a card of
    ``sms`` SMs, B row-major or, with ``k_major``, K-major.  A choice by
    shape and layout: TMA needs 16-byte rows (K and N multiples of 8) and
    aligned bases; of the wgmma tiles, the widest whose grid has at least
    ``sms / 2`` tiles; a K-major B goes to the tile of its shape among those
    that read it so (the wgmma tiles do not)."""
    tail = "_kmajor" if k_major else ""
    if dtype == torch.float32:
        return "fma" + tail
    if m <= DECODE_MAX_M:
        return "decode" + tail
    if k_major or k == 0 or k % 8 or n % 8 or not aligned:
        return "wmma" + tail
    for path, bm, bn in WGMMA_TILES[:-1]:
        if 2 * math.ceil(m / bm) * math.ceil(n / bn) >= sms:
            return path
    return WGMMA_TILES[-1][0]


def launch_path(path: str | None, k_chunk: int, source: str, m: int, n: int, k: int, dtype: torch.dtype,
                aligned: bool, k_major: bool, sms: int) -> tuple[str, int, str]:
    """(path, k_chunk, source) that a launch runs: ``gemm_path``'s ("rule")
    when ``path`` is None, else ``path`` if the operands can take it; a
    tuned path (``source`` "tuned") they cannot take gives way to
    ``gemm_path``'s, counted as "tuned_refused"; any other raises.  Only a
    path the caller names is checked: ``gemm_path`` picks one that fits."""
    if path is None:
        return gemm_path(m, n, k, dtype, aligned, sms, k_major), 0, "rule"
    if source == "tuned" and aligned and not k_major:
        return path, k_chunk, source  # the plan cache's table checked it on such operands (tune.cache)
    refusal = path_refusal(path, m, n, k, dtype, aligned, k_major, k_chunk)
    if refusal is None:
        return path, k_chunk, source
    if source == "tuned":
        return gemm_path(m, n, k, dtype, aligned, sms, k_major), 0, "tuned_refused"
    raise ValueError(f"systolic kernel: {refusal}")


@functools.cache
def _sm_count(device_index: int | None) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SMs a launch on ``device`` has; on the CPU the H100's, so the
    plain version's dispatch settles the path the card would."""
    return _sm_count(device.index) if device.type == "cuda" else hw.H100.n_sm


def aligned(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Both operand bases 16-byte aligned, as TMA needs them."""
    return a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0


def systolic_matmul_call(
    a: torch.Tensor,
    b: torch.Tensor,
    bias: torch.Tensor | None,
    *,
    out_dtype: torch.dtype,
    activation: str = "none",
    path: str | None = None,
    k_chunk: int = 0,
    plan_source: str = "rule",
    settled: bool = False,
) -> torch.Tensor:
    """a: (M, K), b: (K, N), bias: (N,) or None -> (M, N) on the card.

    a and b are CUDA tensors of one dtype (bf16 or fp32), a row-major
    contiguous, b row-major contiguous or K-major (``is_k_major``: the
    transpose of a contiguous (N, K) tensor, read in place); the output
    dtype is bf16 or fp32.  ``path``: the path to launch (None: ``gemm_path``'s
    choice), with ``k_chunk`` the decode tile's contraction per block (0:
    ``plan_split``'s); ``plan_source`` names where it came from ("explicit",
    "tuned"), for the launch counters.  A path the operands cannot take
    raises, but for a tuned one, which gives way to the rule
    (``launch_path``).  ``settled``: the caller ran ``launch_path`` on these
    operands and passes its result (``ops.matmul``, which records the
    launch), so it is not run again.  Raises on anything the kernel does not
    take.
    """
    global launches
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"systolic kernel needs both operands on one CUDA device, got {a.device}, {b.device}")
    if a.dtype not in DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"systolic kernel takes bf16 or fp32 operands of one dtype, got {a.dtype}, {b.dtype}")
    if out_dtype not in DTYPE_CODES:
        raise TypeError(f"systolic kernel writes bf16 or fp32, not {out_dtype}")
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected (M, K) @ (K, N), got {tuple(a.shape)} @ {tuple(b.shape)}")
    k_major = not b.is_contiguous() and is_k_major(b)
    if not (a.is_contiguous() and (b.is_contiguous() or k_major)):
        raise ValueError(f"systolic kernel needs A row-major contiguous and B row-major contiguous or K-major; "
                         f"got A strides {a.stride()}, B strides {b.stride()}")
    m, k = a.shape
    n = b.shape[1]
    if bias is not None:
        if bias.shape != (n,) or bias.device != a.device:
            raise ValueError(f"bias must be ({n},) on {a.device}, got {tuple(bias.shape)} on {bias.device}")
        bias = bias.to(torch.float32).contiguous()
    if max(m, n, k) >= 2**31:
        raise ValueError("systolic kernel dimensions must fit in int32")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    al = aligned(a, b)
    if not settled:
        path, k_chunk, plan_source = launch_path(path, k_chunk, plan_source, m, n, k, a.dtype, al, k_major,
                                                 _sm_count(a.device.index))
    lib, fn = _entry("systolic_mmm")
    ws, nbytes = _workspace("systolic_mmm", a.device, m, n, k, path.startswith("decode"), k_chunk)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = fn(
        a.data_ptr(), b.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), m, n, k, DTYPE_CODES[a.dtype], DTYPE_CODES[out_dtype],
        ACTIVATION_CODES[activation], PATHS.index(path), k_chunk, None if ws is None else ws.data_ptr(), nbytes,
        stream,
    )
    _build.check(lib, "systolic_mmm launch", code)
    launches += 1
    launches_by_shape[(m, k, n)] += 1
    launches_by_path[path] += 1
    launches_by_plan[(m, k, n, path, k_chunk, plan_source, al)] += 1
    return out


# ---------------------------------------------------------------------------
# Block-scaled int8 / fp8 GEMM (``csrc/systolic_qmm.cu``): the counterpart of
# ``repro.kernels.systolic.kernel.quant_systolic_matmul_call``.
# ---------------------------------------------------------------------------

QDTYPE_CODES = {torch.int8: 0, torch.float8_e4m3fn: 1}
# int8 x int8 products are at most 128^2 = 2^14, so one scale step sums
# exactly in int32 up to this many k.
MAX_INT8_STEP = (2**31 - 1) // 2**14

# The block-scaled GEMM's paths, numbered as in csrc/systolic_qmm.cu:
#   decode  M <= 16: the WMMA 16-row tile, contraction split across blocks;
#   wmma    the WMMA 128x128 tile, for prefill shapes the wgmma tile does not take;
#   wgmma   int8 prefill: TMA ring + 8-bit wgmma (m64n128k32), partials
#           retired in registers.
# Every path reads B K-major (8-bit wgmma has no transpose for it).
#           fp8 stays on the WMMA tiles: e4m3 wgmma accumulates with fewer
#           bits than the plain version's tolerance allows (csrc/systolic_qmm.cu).
QPATHS = ("decode", "wmma", "wgmma")
WGMMA_QK = 128  # the wgmma tile's k stage (csrc/systolic_qmm.cu Q_BK): its scale steps are multiples of it


def qtiles(dtype: torch.dtype) -> dict[str, tuple[int, int, int]]:
    """Each path's tile as (bm, bn, bk) for ``dtype`` values (csrc/
    systolic_qmm.cu): the decode tile's k stage (its split stays
    ``plan_split``'s), the WMMA tile's (64 int8, 32 e4m3), the int8 wgmma
    tile's 128; e4m3 has no wgmma tile."""
    tiles = {"decode": TILES["decode"], "wmma": (128, 128, 64 if dtype == torch.int8 else 32)}
    if dtype == torch.int8:
        tiles["wgmma"] = (128, 128, WGMMA_QK)
    return tiles


QTHREADS = {"decode": 128, "wmma": 256, "wgmma": 384}  # csrc/systolic_qmm.cu: 32 per warp; QTile::NT


def qlaunch_of(path: str, m: int, n: int, k: int, dtype: torch.dtype, sms: int) -> _build.Launch:
    """The launch the block-scaled GEMM's ``path`` runs an (M, K) @ (K, N)
    product of ``dtype`` values with, as ``launch_of`` accounts for K1's:
    the decode tile split as ``plan_split`` rules (no tuned chunk), the int8
    wgmma tile's ring with one stage's scales as dynamic shared memory."""
    bm, bn, bk = qtiles(dtype)[path]
    splits, chunk = plan_split(m, n, k, sms) if path == "decode" else (1, k)
    dyn = BlockPlan(m, n, k, bm, bn, bk, in_dtype=hw._dtype_name(dtype),
                    quant_block_k=WGMMA_QK).smem_bytes() if path == "wgmma" else 0
    return _build.Launch((-(-n // bn), -(-m // bm), splits), QTHREADS[path], dyn, splits, chunk if splits > 1 else 0)


def qlaunch_query(path: str, m: int, n: int, k: int, qk_a: int, qk_b: int, dtype: torch.dtype,
                  out_dtype: torch.dtype) -> tuple[_build.Launch, _build.Compiled]:
    """``launch_query`` of the block-scaled GEMM (``systolic_qmm_query``)."""
    return _build.query(_entry("systolic_qmm")[0], "systolic_qmm_query", m, n, k, qk_a, qk_b, QDTYPE_CODES[dtype],
                        DTYPE_CODES[out_dtype], QPATHS.index(path))


def qpath_of_block(bm: int, bn: int, bk: int, dtype: torch.dtype) -> str:
    """The block-scaled GEMM's path that a (bm, bn, bk) geometry names for
    ``dtype`` values; raises on a geometry no tile runs."""
    for path, tile in qtiles(dtype).items():
        if tile == (bm, bn, bk):
            return path
    raise ValueError(f"no block-scaled tile runs the block ({bm}, {bn}, {bk}) on {dtype}; tiles: {qtiles(dtype)}")


def qlaunch_path(path: str | None, source: str, m: int, n: int, k: int, step: int, dtype: torch.dtype,
                 aligned: bool) -> tuple[str, str]:
    """(path, source) that a launch of the block-scaled GEMM runs, as
    ``launch_path`` decides it, with ``qgemm_path`` the rule."""
    if path is None:
        return qgemm_path(m, n, k, step, dtype, aligned), "rule"
    refusal = qpath_refusal(path, m, n, k, step, dtype, aligned)
    if refusal is None:
        return path, source
    if source == "tuned":
        return qgemm_path(m, n, k, step, dtype, aligned), "tuned_refused"
    raise ValueError(f"quantized kernel: {refusal}")


def launch_step(qk_a: int, qk_b: int, k: int) -> int:
    """The scale step a launch hands ``qlaunch_path``: 0 for whole-K scales
    (a scale block spanning K is whole-K), else ``scale_step``'s."""
    qk_a, qk_b = (q if q < k else 0 for q in (qk_a, qk_b))
    return scale_step(qk_a, qk_b, k) if (qk_a or qk_b) else 0


def qpath_refusal(path: str, m: int, n: int, k: int, step: int, dtype: torch.dtype, aligned: bool) -> str | None:
    """Why ``path`` cannot take these operands (None: it can), as the
    kernel checks them (csrc/systolic_qmm.cu); ``step`` as for ``qgemm_path``."""
    if path not in QPATHS:
        return f"unknown path {path!r}; paths: {QPATHS}"
    if (path == "decode") != (m <= DECODE_MAX_M):
        return f"the decode tile takes M <= {DECODE_MAX_M} and the others M > {DECODE_MAX_M}; M is {m}"
    if path == "wgmma" and not (dtype == torch.int8 and aligned and k % 16 == 0 and n % 8 == 0
                                and step % WGMMA_QK == 0):
        return f"the wgmma tile needs int8 values, K a multiple of 16, N of 8, aligned bases and a scale step " \
               f"of whole K or a multiple of {WGMMA_QK}; got {dtype}, K={k}, N={n}, aligned={aligned}, step={step}"
    return None


# Launches of the quantized kernel made by this process, in all, by (M, K, N),
# by path, and by (M, K, N, path, source, values' dtype name, scale blocks
# qk_a, qk_b as the kernel took them, aligned), the source and alignment as
# in ``launches_by_plan``: what an audit of the launch needs.
quant_launches = 0
quant_launches_by_shape: collections.Counter = collections.Counter()
quant_launches_by_path: collections.Counter = collections.Counter()
quant_launches_by_plan: collections.Counter = collections.Counter()


def is_k_major(b: torch.Tensor) -> bool:
    """A (K, N) operand stored K-major: the transpose of an (N, K) row-major
    matrix, strides (1, K) (``quant.k_major`` lays the w8a8 weights out
    so).  The block-scaled kernel reads B only so."""
    return b.t().is_contiguous()


def qgemm_path(m: int, n: int, k: int, step: int, dtype: torch.dtype, aligned: bool) -> str:
    """The block-scaled GEMM's path for an (M, K) @ (K, N) product of
    ``dtype`` values with scale step ``step`` (0: one scale block over all of
    K) and operand bases 16-byte aligned (``aligned``).  A choice by shape
    and dtype: the wgmma tile is int8's; TMA needs 16-byte rows (K a
    multiple of 16) and aligned bases, the tile's retire at the ends of its
    128-deep k stages a step of whole K or a multiple of 128 (served: 128),
    the staged epilogue N a multiple of 8."""
    if m <= DECODE_MAX_M:
        return "decode"
    if dtype == torch.int8 and aligned and k % 16 == 0 and n % 8 == 0 and step % WGMMA_QK == 0:
        return "wgmma"
    return "wmma"


def scale_step(qk_a: int, qk_b: int, k: int) -> int:
    """The run of k that lies inside one scale block of both operands: the
    gcd of the non-zero scale blocks (0 = whole K), K when both are whole-K.
    The reference clamps its k block to the same gcd."""
    steps = [q for q in (qk_a, qk_b) if q]
    return math.gcd(*steps) if steps else k


def quant_systolic_matmul_call(
    a: torch.Tensor,
    a_scales: torch.Tensor,
    b: torch.Tensor,
    b_scales: torch.Tensor,
    *,
    qk_a: int,
    qk_b: int,
    out_dtype: torch.dtype,
    activation: str = "none",
    path: str | None = None,
    plan_source: str = "rule",
    settled: bool = False,
) -> torch.Tensor:
    """a: (M, K), b: (K, N) int8 or float8_e4m3fn (one dtype); a_scales:
    (M, ceil(K / qk_a)) and b_scales: (ceil(K / qk_b), N) fp32, where a scale
    block of 0 spans all of K (one scale column / row) -> (M, N) on the card.
    a and the scales are row-major contiguous; b is K-major (``is_k_major``),
    the one layout the kernel reads.  ``path``: the path to launch (None:
    ``qgemm_path``'s choice), ``plan_source`` and ``settled`` as for
    ``systolic_matmul_call`` (``qlaunch_path``).

    Validates everything the kernel does not take and raises; the checks on
    dtypes, shapes, layouts and the scale step come before the device check,
    so they hold on any host.
    """
    global quant_launches
    if a.dtype not in QDTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"quantized kernel takes int8 or float8_e4m3fn operands of one dtype, got {a.dtype}, {b.dtype}")
    if a_scales.dtype != torch.float32 or b_scales.dtype != torch.float32:
        raise TypeError(f"quantized kernel takes fp32 scales, got {a_scales.dtype}, {b_scales.dtype}")
    if out_dtype not in DTYPE_CODES:
        raise TypeError(f"quantized kernel writes bf16 or fp32, not {out_dtype}")
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected (M, K) @ (K, N), got {tuple(a.shape)} @ {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if k == 0 or qk_a < 0 or qk_b < 0:
        raise ValueError(f"quantized kernel needs K > 0 and scale blocks >= 0, got K={k}, qk=({qk_a}, {qk_b})")
    want_a = (m, -(-k // qk_a) if qk_a else 1)
    want_b = (-(-k // qk_b) if qk_b else 1, n)
    if tuple(a_scales.shape) != want_a or tuple(b_scales.shape) != want_b:
        raise ValueError(
            f"scale shapes {tuple(a_scales.shape)}, {tuple(b_scales.shape)} do not fit "
            f"({m}, {k}) @ ({k}, {n}) with qk_a={qk_a}, qk_b={qk_b}: want {want_a}, {want_b}"
        )
    # A scale block that spans K is whole-K (the kernel's 0).
    qk_a, qk_b = (q if q < k else 0 for q in (qk_a, qk_b))
    step = scale_step(qk_a, qk_b, k)
    if (qk_a or qk_b) and step % 16:
        raise ValueError(
            f"scale step {step} (qk_a={qk_a}, qk_b={qk_b}, K={k}) is neither whole-K nor a "
            "multiple of 16, the kernel's k granularity"
        )
    if a.dtype == torch.int8 and step > MAX_INT8_STEP:
        raise ValueError(f"int8 scale step {step} could overflow the int32 partial (max {MAX_INT8_STEP})")
    if max(m, n, k) >= 2**31:
        raise ValueError("quantized kernel dimensions must fit in int32")
    if not (all(t.is_contiguous() for t in (a, a_scales, b_scales)) and is_k_major(b)):
        raise ValueError(f"quantized kernel needs A and the scales row-major contiguous and B K-major "
                         f"(strides (1, {k})); got A strides {a.stride()}, B strides {b.stride()}")
    tensors = (a, a_scales, b, b_scales)
    if a.device.type != "cuda" or any(t.device != a.device for t in tensors):
        raise ValueError(f"quantized kernel needs every operand on one CUDA device, got {[str(t.device) for t in tensors]}")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    al = aligned(a, b)
    if not settled:
        path, plan_source = qlaunch_path(path, plan_source, m, n, k, launch_step(qk_a, qk_b, k), a.dtype, al)
    lib, fn = _entry("systolic_qmm")
    ws, nbytes = _workspace("systolic_qmm", a.device, m, n, k, True)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = fn(
        a.data_ptr(), a_scales.data_ptr(), b.data_ptr(), b_scales.data_ptr(), out.data_ptr(),
        m, n, k, qk_a, qk_b, QDTYPE_CODES[a.dtype], DTYPE_CODES[out_dtype],
        ACTIVATION_CODES[activation], QPATHS.index(path), None if ws is None else ws.data_ptr(),
        nbytes, stream,
    )
    _build.check(lib, "systolic_qmm launch", code)
    quant_launches += 1
    quant_launches_by_shape[(m, k, n)] += 1
    quant_launches_by_path[path] += 1
    quant_launches_by_plan[(m, k, n, path, plan_source, hw._dtype_name(a.dtype), qk_a, qk_b, al)] += 1
    return out
