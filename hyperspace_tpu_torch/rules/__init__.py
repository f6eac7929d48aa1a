"""Index-aware plan rewriting (the filter and join rules)."""
