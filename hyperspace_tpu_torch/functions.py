"""Aggregate function builders for ``DataFrame.agg`` / ``GroupedData.agg``.

Counterpart of ``hyperspace_tpu/functions.py``.

The Spark-shaped surface (``F.sum("x").alias("total")``) over the engine's
:class:`~hyperspace_tpu_torch.plan.nodes.AggSpec`.
"""

from __future__ import annotations

from typing import Optional

from hyperspace_tpu_torch.plan.nodes import AggSpec


def _spec(func: str, column: Optional[str]) -> AggSpec:
    arg = "*" if column is None else column
    return AggSpec(func, column, f"{func}({arg})")


def alias(spec: AggSpec, name: str) -> AggSpec:
    return spec.alias(name)


def sum(column: str) -> AggSpec:  # noqa: A001 - Spark-shaped API
    return _spec("sum", column)


def count(column: Optional[str] = None) -> AggSpec:
    return _spec("count", column)


def min(column: str) -> AggSpec:  # noqa: A001
    return _spec("min", column)


def max(column: str) -> AggSpec:  # noqa: A001
    return _spec("max", column)


def avg(column: str) -> AggSpec:
    return _spec("avg", column)


mean = avg
