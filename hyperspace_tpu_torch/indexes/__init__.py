"""Index kinds ("derived datasets"). This slice ports the covering index."""
