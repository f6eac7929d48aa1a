"""Harnesses shipped with the package: fault and crash injection
(``faults``), the randomized lifecycle harness (``chaos``), workload
replay (``replay``) and the runtime witnesses of the registries
(``lock_witness``, ``residency_witness``, ``collective_witness``, with
``artifacts`` for their JSON files).

``testing.faults`` is imported by production modules (its points sit in
the log manager, the parquet reads and writes, the actions and the
sidecar publish), so it stays stdlib-only and cheap to import.
"""
