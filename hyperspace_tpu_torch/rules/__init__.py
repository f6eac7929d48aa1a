"""Index-aware plan rewriting (the filter rule in this slice)."""
