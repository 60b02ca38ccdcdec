"""Analysis of the port (port of ``repro.analysis``).

Layer 1 -- :mod:`.rules` / :mod:`.linter` / :mod:`.findings` -- lints the
port's tree for the failure modes that have a torch meaning (host syncs in
the serving tick, kernel modules reached around ``kernels/ops.py``).
Layer 2 -- :mod:`.contracts` / :mod:`.retrace` -- checks the registry's
shape and dtype contracts on meta tensors and bounds what a steady state
builds.  Layer 3 -- :mod:`.shardcheck` -- the sharding policy, the
rank-local layout and the dtype flow, and the pool written in place.
Layer 4 -- :mod:`.sanitize` -- the serving engine's runtime guards.

CLI: ``python -m repro_torch.analysis --check``.
"""
from .findings import Finding
from .linter import lint_paths, lint_source

__all__ = ["Finding", "lint_paths", "lint_source"]
