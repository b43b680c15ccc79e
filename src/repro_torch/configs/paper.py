"""The paper's own design points (Table I) as framework configs.

The counterpart of ``repro.configs.paper``: GEMM design-space points, not LM
architectures, which the analytical regression tests and the DSE table of
``chip_smoke.py`` consume.  The card's translation of each design is the
block plan of the systolic kernel's tile whose shape is nearest the design's
array (``block_plan_for``).
"""

from __future__ import annotations

import math

from repro_torch.core.analytical import PaperDesign, paper_designs
from repro_torch.core.blocking import BlockPlan

# Matrix sizes the paper measures (Tables II-V): multiples of d1.
PAPER_MATRIX_SIZES = {
    "C": [672, 1344, 2688, 5376, 10752, 21504],
    "E": [576, 1152, 2304, 4608, 9216, 18432],
    "F": [560, 1120, 2240, 4480, 8960, 17920],
    "G": [512, 1024, 2048, 4096, 8192, 16384],
    "H": [512, 1024, 2048, 4096, 8192, 16384],
    "I": [512, 1024, 2048, 4096, 8192, 16384],
    "L": [512, 1024, 2048, 4096, 8192, 16384],
    "M": [512, 1024, 2048, 4096, 8192, 16384],
    "N": [512, 1024, 2048, 4096, 8192, 16384],
}


def designs() -> dict[str, PaperDesign]:
    return paper_designs()


def block_plan_for(design: PaperDesign, d2: int) -> BlockPlan:
    """The card's analogue of one paper design at problem size d2^3 (the
    reference's ``tpu_block_plan_for``).

    The rule: the design's C-stationary (d_i0, d_j0) array becomes the
    systolic kernel's wgmma tile (``kernels/systolic/kernel.py`` ``TILES``)
    whose aspect bm / bn is nearest d_i0 / d_j0 on a log scale, the larger
    tile on a tie (more reuse per operand byte, eq. 14); d_k0, the depth one
    array step contracts, becomes the tile's 64-deep k stage, the contraction
    one wgmma ring stage holds.  Every Table I array is 16-72 PEs a side,
    far below one 64 x 128 tile, so only the aspect carries over.
    """
    from repro_torch.kernels.systolic.kernel import WGMMA_TILES, TILES

    arr = design.array
    want = math.log2(arr.d_i0 / arr.d_j0)
    path = min(
        (p for p, _, _ in WGMMA_TILES),
        key=lambda p: (abs(math.log2(TILES[p][0] / TILES[p][1]) - want), -TILES[p][0] * TILES[p][1]),
    )
    bm, bn, bk = TILES[path]
    return BlockPlan(d2, d2, d2, bm, bn, bk)
