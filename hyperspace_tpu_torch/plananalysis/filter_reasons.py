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

    @property
    def arg_string(self) -> str:
        return ", ".join(f"{k}={v}" for k, v in self.args)

    def to_string(self, extended: bool = False) -> str:
        if extended and self.verbose:
            return f"[{self.code}] {self.verbose}"
        return f"[{self.code}] {self.arg_string}"


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


def no_delete_support() -> FilterReason:
    return FilterReason(
        "NO_DELETE_SUPPORT",
        (),
        "Source files were deleted but the index has no lineage column.",
    )


def too_much_appended(appended_ratio: float, threshold: float) -> FilterReason:
    return FilterReason(
        "TOO_MUCH_APPENDED",
        (("appendedRatio", f"{appended_ratio:.3f}"), ("threshold", str(threshold))),
        "Appended bytes exceed the Hybrid Scan threshold.",
    )


def too_much_deleted(deleted_ratio: float, threshold: float) -> FilterReason:
    return FilterReason(
        "TOO_MUCH_DELETED",
        (("deletedRatio", f"{deleted_ratio:.3f}"), ("threshold", str(threshold))),
        "Deleted bytes exceed the Hybrid Scan threshold.",
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


def no_indexed_col_cond(indexed: str, condition_cols: str) -> FilterReason:
    return FilterReason(
        "NO_INDEXED_COL_COND",
        (("indexedCols", indexed), ("conditionCols", condition_cols)),
        "The filter constrains none of the index's indexed columns.",
    )


def not_eligible_join(reason: str) -> FilterReason:
    return FilterReason(
        "NOT_ELIGIBLE_JOIN",
        (("reason", reason),),
        "The join shape is not eligible for the join-index rewrite.",
    )


def no_avail_join_index_pair(side: str) -> FilterReason:
    return FilterReason(
        "NO_AVAIL_JOIN_INDEX_PAIR",
        (("child", side),),
        "No compatible index pair covers both join sides.",
    )


def not_covering_filter(reason: str) -> FilterReason:
    return FilterReason("NOT_APPLICABLE", (("reason", reason),), reason)


def another_index_applied(applied: str) -> FilterReason:
    return FilterReason(
        "ANOTHER_INDEX_APPLIED",
        (("appliedIndex", applied),),
        "A different index scored higher for this subtree.",
    )


def ineligible_predicate(reason: str) -> FilterReason:
    return FilterReason(
        "INELIGIBLE_FILTER_CONDITION",
        (("reason", reason),),
        "The filter condition cannot be translated for this index.",
    )
