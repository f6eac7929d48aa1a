"""Logical plan IR: typed expressions and Scan/Filter/Project nodes."""
