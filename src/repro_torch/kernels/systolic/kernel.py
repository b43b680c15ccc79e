"""ctypes bindings of the hand-written CUDA systolic GEMMs.

``systolic_matmul_call`` (``csrc/systolic_mmm.cu``) is the counterpart of
``repro.kernels.systolic.kernel.systolic_matmul_call``: one launch computes
``act(A @ B [+ bias])`` with an fp32 accumulator, on the path that
``gemm_path`` picks by shape, dtype and alignment.  ``quant_systolic_matmul_call``
(``csrc/systolic_qmm.cu``) is the block-scaled int8 / fp8 GEMM.  Both
kernels mask ragged edges themselves, so shapes need not divide any block.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

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

# Kernel launches made by this process, in all, by (M, K, N) and by path
# (read and reset by chip_smoke.py).
launches = 0
launches_by_shape: collections.Counter = collections.Counter()
launches_by_path: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


# Argument types of each library's C entry point, named as the library.
_ARGTYPES = {
    "systolic_mmm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _LL, _P],
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
    lib.split_workspace.argtypes = [_I, _I, _I, _I]
    lib.split_workspace.restype = _LL
    return lib, fn


@functools.cache
def _workspace_bytes(name: str, m: int, n: int, k: int, splittable: bool, device_index: int | None) -> int:
    """fp32 scratch bytes of the split-K partials (``csrc/common.cuh``
    ``plan_split``); depends on the shape and the card's SM count, so it is
    asked once per shape and card."""
    return _entry(name)[0].split_workspace(m, n, k, int(splittable))


def _workspace(name: str, device: torch.device, m: int, n: int, k: int, splittable: bool):
    """(scratch tensor or None, its bytes) for one launch of library ``name``."""
    nbytes = _workspace_bytes(name, m, n, k, splittable, device.index)
    ws = torch.empty(nbytes // 4, dtype=torch.float32, device=device) if nbytes else None
    return ws, nbytes


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


@functools.cache
def _sm_count(device_index: int | None) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def systolic_matmul_call(
    a: torch.Tensor,
    b: torch.Tensor,
    bias: torch.Tensor | None,
    *,
    out_dtype: torch.dtype,
    activation: str = "none",
) -> torch.Tensor:
    """a: (M, K), b: (K, N), bias: (N,) or None -> (M, N) on the card.

    a and b are CUDA tensors of one dtype (bf16 or fp32), a row-major
    contiguous, b row-major contiguous or K-major (``is_k_major``: the
    transpose of a contiguous (N, K) tensor, read in place); the output
    dtype is bf16 or fp32.  Raises on anything the kernel does not take.
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
    lib, fn = _entry("systolic_mmm")
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    path = gemm_path(m, n, k, a.dtype, aligned, _sm_count(a.device.index), k_major)
    ws, nbytes = _workspace("systolic_mmm", a.device, m, n, k, path.startswith("decode"))
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = fn(
        a.data_ptr(), b.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), m, n, k, DTYPE_CODES[a.dtype], DTYPE_CODES[out_dtype],
        ACTIVATION_CODES[activation], PATHS.index(path), None if ws is None else ws.data_ptr(), nbytes, stream,
    )
    _build.check(lib, "systolic_mmm launch", code)
    launches += 1
    launches_by_shape[(m, k, n)] += 1
    launches_by_path[path] += 1
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

# Launches of the quantized kernel made by this process, in all, by (M, K, N)
# and by path.
quant_launches = 0
quant_launches_by_shape: collections.Counter = collections.Counter()
quant_launches_by_path: collections.Counter = collections.Counter()


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
) -> torch.Tensor:
    """a: (M, K), b: (K, N) int8 or float8_e4m3fn (one dtype); a_scales:
    (M, ceil(K / qk_a)) and b_scales: (ceil(K / qk_b), N) fp32, where a scale
    block of 0 spans all of K (one scale column / row) -> (M, N) on the card.
    a and the scales are row-major contiguous; b is K-major (``is_k_major``),
    the one layout the kernel reads.

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
    lib, fn = _entry("systolic_qmm")
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    path = qgemm_path(m, n, k, step if (qk_a or qk_b) else 0, a.dtype, aligned)
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
    return out
