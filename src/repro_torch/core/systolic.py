"""Plain-PyTorch reference of the paper's algorithm (Definitions 1, 2 and 4).

The counterpart of ``repro.core.systolic``: the dataflow structure of the
paper as torch loops -- the algorithmic oracle that the tuner's ``reference``
backend runs and that makes the two-level blocking of Definition 4
executable on any device.  The reference's ``lax.fori_loop`` / ``lax.scan``
become Python loops with the same order.

Structure map (paper -> here):
  Listing 1 loop over T (K/d_k0 blocks)        -> the loop in ``systolic_mmm``
  Listing 2 three unrolled loops (i, j, k)      -> one block product; the
    per-layer dot-product-unit stack of Def. 2  -> ``_onchip_mmm_layered``
    (a loop over d_k0/d_p layers, partial sums flowing up the L axis)
  Definition 4 two-level blocked off-chip GEMM  -> ``blocked_matmul``
    (outer I, J loop = level-1 C-blocks; inner k-slowest outer-product
     accumulation, matching Section V's four phases)
"""

from __future__ import annotations

import torch

from repro_torch.core.blocking import BlockPlan


def _onchip_mmm_layered(a_blk: torch.Tensor, b_blk: torch.Tensor, c: torch.Tensor, d_p: int) -> torch.Tensor:
    """Definition 2 dataflow: a stack of d_k0/d_p dot-product layers.

    a_blk: (d_i0, d_k0), b_blk: (d_k0, d_j0), c: (d_i0, d_j0) accumulator.
    Layer L computes the partial dot over its d_p-wide k-slice and passes the
    running sum 'up' to layer L+1 (the paper's third dimension); each layer's
    products are taken in the accumulator's dtype.
    """
    d_k0 = a_blk.shape[1]
    if d_k0 % d_p != 0:
        raise ValueError(f"d_k0={d_k0} not a multiple of d_p={d_p}")
    for layer in range(d_k0 // d_p):
        ks = slice(layer * d_p, (layer + 1) * d_p)
        # Each PE row is a dot-product unit of width d_p (eq. 6):
        # r = z + sum_i v_i w_i, with z the partial sum from the layer below.
        c = c + a_blk[:, ks].to(c.dtype) @ b_blk[ks, :].to(c.dtype)
    return c


def systolic_mmm(
    a: torch.Tensor, b: torch.Tensor, d_k0: int, d_p: int | None = None, out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Listing 1: on-chip (d_i0 x K) @ (K x d_j0) via K/d_k0 block steps.

    Equivalent to ``a @ b``; structured as the paper's pipeline -- the T loop
    outside (II=1 pipeline iterations), the layered dot stack inside.
    """
    d_i0, k = a.shape
    k2, d_j0 = b.shape
    assert k == k2, (a.shape, b.shape)
    if k % d_k0 != 0:
        raise ValueError(f"K={k} not a multiple of d_k0={d_k0}")
    d_p = d_p or d_k0
    c = torch.zeros((d_i0, d_j0), dtype=out_dtype, device=a.device)
    for t in range(k // d_k0):
        ks = slice(t * d_k0, (t + 1) * d_k0)
        c = _onchip_mmm_layered(a[:, ks], b[ks, :], c, d_p)
    return c


def classical_mmm(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Definition 1 (Okuda-Song 2D array) semantics: C-stationary MACs.

    The 2D array multiply-accumulates one k-slice per cycle; algebraically a
    rank-1-update loop.  Kept as the baseline the paper compares against.
    """
    c = torch.zeros((a.shape[0], b.shape[1]), dtype=out_dtype, device=a.device)
    for t in range(a.shape[1]):
        c = c + torch.outer(a[:, t], b[t, :]).to(out_dtype)
    return c


def blocked_matmul(a: torch.Tensor, b: torch.Tensor, plan: BlockPlan, d_p: int | None = None) -> torch.Tensor:
    """Definition 4: two-level blocked off-chip matmul, fp32 out.

    Level 1: iterate over the (bm, bn) blocks of C.  Within a level-1 block,
    accumulate outer products with **k slowest** (the paper's ordering that
    avoids the FPGA II=1 accumulation hazard), i.e. phases 1-4 of Section V.
    The CUDA kernels run the contraction innermost in each block; this
    reference keeps the paper's order, so that both orders are held to agree.
    """
    m, k = a.shape
    k2, n = b.shape
    assert k == k2
    bm, bn, bk = plan.bm, plan.bn, plan.bk
    if m % bm or n % bn or k % bk:
        raise ValueError(f"shapes ({m},{n},{k}) not divisible by blocks {bm, bn, bk}")
    d_p = d_p or bk
    c = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    for i in range(m // bm):
        rows = slice(i * bm, (i + 1) * bm)
        for j in range(n // bn):
            cols = slice(j * bn, (j + 1) * bn)
            # Section V phases: Read is implicit, Compute is the k-slowest
            # accumulation, Write is the block store at the end.
            c1 = torch.zeros((bm, bn), dtype=torch.float32, device=a.device)
            for t in range(k // bk):
                ks = slice(t * bk, (t + 1) * bk)
                c1 = _onchip_mmm_layered(a[rows, ks], b[ks, cols], c1, d_p)
            c[rows, cols] = c1
    return c
