"""FilterReason catalog — why an index was NOT applied.

Reference: ``plananalysis/FilterReason.scala:33-158``. Each reason has a
stable code plus an argument list; ``why_not`` renders them per index.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FilterReason:
    code: str
    args: Tuple[Tuple[str, str], ...] = ()
    verbose: str = ""


def col_schema_mismatch(index_cols: str, relation_cols: str) -> FilterReason:
    return FilterReason(
        "COL_SCHEMA_MISMATCH",
        (("indexCols", index_cols), ("relationCols", relation_cols)),
        "Index columns are not part of the relation's schema.",
    )


def source_data_changed() -> FilterReason:
    return FilterReason(
        "SOURCE_DATA_CHANGED",
        (),
        "Source data changed since the index was built and Hybrid Scan "
        "is disabled or inapplicable.",
    )


def missing_required_col(required: str, index_cols: str) -> FilterReason:
    return FilterReason(
        "MISSING_REQUIRED_COL",
        (("requiredCols", required), ("indexCols", index_cols)),
        "The query needs columns the index does not cover.",
    )


def no_first_indexed_col_cond(first_indexed: str, condition_cols: str) -> FilterReason:
    return FilterReason(
        "NO_FIRST_INDEXED_COL_COND",
        (("firstIndexedCol", first_indexed), ("conditionCols", condition_cols)),
        "The filter does not constrain the index's first indexed column.",
    )


def not_eligible_join(reason: str) -> FilterReason:
    return FilterReason(
        "NOT_ELIGIBLE_JOIN",
        (("reason", reason),),
        "The join shape is not eligible for the join-index rewrite.",
    )


def another_index_applied(applied: str) -> FilterReason:
    return FilterReason(
        "ANOTHER_INDEX_APPLIED",
        (("appliedIndex", applied),),
        "A different index scored higher for this subtree.",
    )
