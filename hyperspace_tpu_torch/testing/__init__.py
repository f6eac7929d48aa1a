"""Harnesses shipped with the package: fault and crash injection
(``faults``) and the randomized lifecycle harness (``chaos``).

``testing.faults`` is imported by production modules (its points sit in
the log manager, the parquet reads and writes, the actions and the
sidecar publish), so it stays stdlib-only and cheap to import.
"""
