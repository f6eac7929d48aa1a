"""Metadata plane: operation log, versioned index data, path layout.

Counterpart of ``hyperspace_tpu/metadata``; the on-disk layout and the
log-entry JSON are identical, so each package reads the other's indexes.
"""
