"""repro_torch.check -- static checks keeping the port's resource model honest.

The counterpart of ``repro.check``.  Two engines:

* **Contract auditor** (``repro_torch.check.audit``): settles each kernel
  dispatch the way the card's dispatcher does (plan, path, tile) and holds a
  plan's claims -- the tile it names, the grid that tiles the problem, the
  shared memory ``BlockPlan.smem_bytes()`` declares, the split-K workspace,
  dtype widths, the FLOPs the telemetry records -- against the launch the
  kernel makes.  On the card (the default) it also holds them against what
  each binary reports of that launch (grid, threads, shared memory) and of
  its compiled kernel (registers, spills).  The analogue of mechanically
  checking the paper's DSP/M20K resource model against the synthesized
  design instead of trusting it.

* **Invariant linter** (``repro_torch.check.lint``): stdlib-``ast`` rule
  pack over the port's idioms (CUDA only behind kernels/ bindings, freed
  slots must end at pos=-1, spans need request identity, no hardcoded
  dtype bytes, gated telemetry records, ...).

CLI: ``python -m repro_torch.check [paths]``; findings gate against the
checked-in, empty ``baseline.json`` -- failures are *new* findings only.
"""

from repro_torch.check.findings import AUDIT, LINT, Finding  # noqa: F401
