"""pmemlint for the port: invariant lint passes and the persistence-order
sanitizer, copies of the JAX package's ``analysis/`` (the port imports
nothing of it).

  * ``repro_torch.analysis.lint`` — the AST lint's command line
    (``python -m repro_torch.analysis.lint src/repro_torch``): persistence
    ordering, metadata-only recovery and lock discipline.
  * ``repro_torch.analysis.annotations`` — the ``@metadata_only`` /
    ``@rehydration_entry`` markers the call-graph pass keys on.
  * ``repro_torch.analysis.sanitizer`` — a record-and-check shim over the
    port's ``PMemRegion``/``PMemPool`` that checks the committed-tail
    discipline at runtime and enumerates torn-write crash states
    (``pytest -p repro_torch.analysis.pytest_plugin --torch-pmem-sanitize``
    runs the port's tests under it).
"""
from repro_torch.analysis.annotations import metadata_only, rehydration_entry
from repro_torch.analysis.sanitizer import PMemSanitizer

__all__ = ["metadata_only", "rehydration_entry", "PMemSanitizer"]
