"""SQL entry point: ``session.sql("SELECT ...")`` over registered views.

Counterpart of ``hyperspace_tpu/sql.py``, the same grammar building the
port's IR as the reference builds its own.

The reference exposes Hyperspace through Spark SQL by injecting its rule
via the session extension (``HyperspaceSparkSessionExtension.scala:44-69``)
— SQL queries get index rewrites for free because they flow through the
same optimizer. Same architecture here: this module only PARSES SQL into
the engine's logical IR (plan/nodes + plan/expressions); the resulting
DataFrame goes through ``session.execute`` → ``session.optimize``, so
FilterIndexRule/JoinIndexRule/data-skipping apply to SQL exactly as to the
DataFrame API.

Supported grammar (the subset the reference's examples/docs exercise):

    SELECT <*| item[, ...]> FROM <view>
      [JOIN <view> ON <col> = <col> [AND ...]]...
      [WHERE <boolean expr>]
      [GROUP BY col[, ...]]
      [ORDER BY col [ASC|DESC][, ...]]
      [LIMIT n]

    item := col | SUM|MIN|MAX|AVG|COUNT ( col | * ) [AS alias]
    expr := comparisons (= != <> < <= > >=), [NOT] IN (...),
            [NOT] BETWEEN a AND b, IS [NOT] NULL, AND / OR / NOT,
            parentheses; literals: numbers (incl. negative), 'strings',
            TRUE/FALSE/NULL, DATE 'YYYY-MM-DD'. ORDER BY may reference
            columns outside the select list (non-aggregate queries).
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.plan import expressions as E

_AGG_FUNCS = {"sum", "min", "max", "avg", "count", "mean"}

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<string>'(?:[^']|'')*')
  | (?P<number>\d+\.\d+|\.\d+|\d+)
  | (?P<op><>|!=|<=|>=|=|<|>|\(|\)|,|\*|-)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
    """,
    re.VERBOSE,
)


def _tokenize(sql: str) -> List[Tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if m is None:
            raise HyperspaceException(
                f"SQL syntax error at {sql[pos:pos + 20]!r}"
            )
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        out.append((kind, m.group()))
    out.append(("end", ""))
    return out


class _Parser:
    def __init__(self, sql: str):
        self.toks = _tokenize(sql)
        self.i = 0

    # -- token helpers ------------------------------------------------------
    def peek(self) -> Tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> Tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def at_keyword(self, *words: str) -> bool:
        kind, val = self.peek()
        return kind == "ident" and val.lower() in words

    def expect_keyword(self, word: str) -> None:
        if not self.at_keyword(word):
            raise HyperspaceException(
                f"Expected {word.upper()}, got {self.peek()[1]!r}"
            )
        self.next()

    def expect_op(self, op: str) -> None:
        kind, val = self.next()
        if kind != "op" or val != op:
            raise HyperspaceException(f"Expected {op!r}, got {val!r}")

    def ident(self) -> str:
        kind, val = self.next()
        if kind != "ident":
            raise HyperspaceException(f"Expected identifier, got {val!r}")
        return val

    # -- grammar ------------------------------------------------------------
    def parse(self, session, catalog) -> "Any":
        self.expect_keyword("select")
        items = self._select_list()
        self.expect_keyword("from")
        df = self._table(session, catalog)
        while self.at_keyword("join", "inner"):
            if self.at_keyword("inner"):
                self.next()
            self.expect_keyword("join")
            right = self._table(session, catalog)
            self.expect_keyword("on")
            cond = self._expr()
            df = df.join(right, on=cond)
        where = None
        if self.at_keyword("where"):
            self.next()
            where = self._expr()
        group_by: Optional[List[str]] = None
        if self.at_keyword("group"):
            self.next()
            self.expect_keyword("by")
            group_by = [self.ident()]
            while self._eat_comma():
                group_by.append(self.ident())
        order: List[Tuple[str, bool]] = []
        if self.at_keyword("order"):
            self.next()
            self.expect_keyword("by")
            order.append(self._order_item())
            while self._eat_comma():
                order.append(self._order_item())
        limit = None
        if self.at_keyword("limit"):
            self.next()
            kind, val = self.next()
            if kind != "number" or "." in val:
                raise HyperspaceException(f"LIMIT takes an integer, got {val!r}")
            limit = int(val)
        kind, val = self.peek()
        if kind != "end":
            raise HyperspaceException(f"Unexpected trailing SQL at {val!r}")

        if where is not None:
            df = df.filter(where)
        # standard SQL allows ORDER BY on columns outside the select list
        # (for non-aggregate queries): sort before projecting in that case
        sorted_early = False
        if order and group_by is None and not any(
            it[0] == "agg" for it in items
        ) and items != [("star",)]:
            selected = {it[1].lower() for it in items if it[0] == "col"}
            if any(c.lower() not in selected for c, _ in order):
                df = df.sort(*order)
                sorted_early = True
        df = self._apply_select(df, items, group_by)
        if order and not sorted_early:
            df = df.sort(*order)
        if limit is not None:
            df = df.limit(limit)
        return df

    def _table(self, session, catalog):
        name = self.ident()
        key = name.lower()
        if key not in catalog:
            raise HyperspaceException(
                f"Unknown table or view {name!r}; register with "
                f"df.create_or_replace_temp_view({name!r})"
            )
        return catalog[key]

    def _eat_comma(self) -> bool:
        kind, val = self.peek()
        if kind == "op" and val == ",":
            self.next()
            return True
        return False

    def _order_item(self) -> Tuple[str, bool]:
        col = self.ident()
        asc = True
        if self.at_keyword("asc"):
            self.next()
        elif self.at_keyword("desc"):
            self.next()
            asc = False
        return col, asc

    # select list: ("col", name, alias) | ("agg", func, col|None, alias)
    def _select_list(self):
        kind, val = self.peek()
        if kind == "op" and val == "*":
            self.next()
            return [("star",)]
        items = [self._select_item()]
        while self._eat_comma():
            items.append(self._select_item())
        return items

    def _select_item(self):
        name = self.ident()
        kind, val = self.peek()
        if name.lower() in _AGG_FUNCS and kind == "op" and val == "(":
            self.next()
            k2, v2 = self.peek()
            if k2 == "op" and v2 == "*":
                self.next()
                col = None
            else:
                col = self.ident()
            self.expect_op(")")
            alias = self._maybe_alias()
            return ("agg", name.lower(), col, alias)
        alias = self._maybe_alias()
        return ("col", name, alias)

    def _maybe_alias(self) -> Optional[str]:
        if self.at_keyword("as"):
            self.next()
            return self.ident()
        return None

    def _apply_select(self, df, items, group_by):
        from hyperspace_tpu_torch import functions as F

        if items == [("star",)]:
            if group_by:
                raise HyperspaceException("SELECT * with GROUP BY")
            return df
        aggs = [it for it in items if it[0] == "agg"]
        cols = [it for it in items if it[0] == "col"]
        if aggs:
            plain = [it[1] for it in cols]
            if group_by is None:
                if plain:
                    raise HyperspaceException(
                        f"Non-aggregated columns {plain} without GROUP BY"
                    )
                group_by = []
            else:
                by_lower = {g.lower(): g for g in group_by}
                missing = [c for c in plain if c.lower() not in by_lower]
                if missing:
                    raise HyperspaceException(
                        f"Columns {missing} must appear in GROUP BY"
                    )
                # resolve select spellings to the GROUP BY spelling (the
                # aggregate's actual output column names)
                items = [
                    ("col", by_lower[it[1].lower()], it[2])
                    if it[0] == "col"
                    else it
                    for it in items
                ]
                cols = [it for it in items if it[0] == "col"]
            specs = []
            for _tag, func, col, alias in aggs:
                spec = (
                    F.count(col) if func == "count" else getattr(F, func)(col)
                )
                if alias:
                    spec = spec.alias(alias)
                specs.append(spec)
            gdf = df.group_by(group_by) if group_by else df.group_by([])
            out = gdf.agg(specs)
            if cols:  # order columns as written
                sel = []
                agg_names = [s.name for s in specs]
                ai = 0
                for it in items:
                    if it[0] == "col":
                        sel.append(it[1])
                    else:
                        sel.append(agg_names[ai])
                        ai += 1
                out = out.select(sel)
            return out
        if group_by:
            raise HyperspaceException("GROUP BY without aggregate functions")
        names = [it[1] for it in cols]
        aliases = [it[2] for it in cols]
        if any(aliases):
            raise HyperspaceException(
                "Column aliases are only supported on aggregates"
            )
        return df.select(names)

    # -- expressions --------------------------------------------------------
    def _expr(self) -> E.Expr:
        return self._or()

    def _or(self) -> E.Expr:
        left = self._and()
        while self.at_keyword("or"):
            self.next()
            left = E.Or(left, self._and())
        return left

    def _and(self) -> E.Expr:
        left = self._not()
        while self.at_keyword("and"):
            self.next()
            left = E.And(left, self._not())
        return left

    def _not(self) -> E.Expr:
        if self.at_keyword("not"):
            self.next()
            return E.Not(self._not())
        return self._primary()

    def _primary(self) -> E.Expr:
        kind, val = self.peek()
        if kind == "op" and val == "(":
            self.next()
            e = self._expr()
            self.expect_op(")")
            return e
        name = self.ident()
        if self.at_keyword("is"):
            self.next()
            negate = False
            if self.at_keyword("not"):
                self.next()
                negate = True
            self.expect_keyword("null")
            e: E.Expr = E.IsNull(E.Col(name))
            return E.Not(e) if negate else e
        if self.at_keyword("in", "not", "between"):
            negate = False
            if self.at_keyword("not"):
                self.next()
                negate = True
            if self.at_keyword("between"):
                self.next()
                lo = self._literal()
                self.expect_keyword("and")
                hi = self._literal()
                e: E.Expr = E.And(
                    E.Ge(E.Col(name), E.Lit(lo)), E.Le(E.Col(name), E.Lit(hi))
                )
                return E.Not(e) if negate else e
            self.expect_keyword("in")
            self.expect_op("(")
            vals = [self._literal()]
            while self._eat_comma():
                vals.append(self._literal())
            self.expect_op(")")
            e = E.Col(name).isin(*vals)
            return E.Not(e) if negate else e
        kind, op = self.next()
        if kind != "op" or op not in ("=", "!=", "<>", "<", "<=", ">", ">="):
            raise HyperspaceException(f"Expected comparison operator, got {op!r}")
        if op == "<>":
            op = "!="
        right = self._operand()
        node = {
            "=": E.Eq,
            "!=": E.Ne,
            "<": E.Lt,
            "<=": E.Le,
            ">": E.Gt,
            ">=": E.Ge,
        }[op]
        return node(E.Col(name), right)

    def _operand(self) -> E.Expr:
        """A comparison's right side: a column reference or a literal.

        ``TRUE``/``FALSE``/``NULL`` are reserved words (a column literally
        named one of them cannot appear as a bare operand — quote-free
        SQL has no way to disambiguate). ``DATE`` is only a keyword when
        a quoted string follows (``DATE '1994-01-01'``); otherwise it is
        an ordinary column name."""
        kind, val = self.peek()
        if kind == "ident":
            low = val.lower()
            is_date_literal = (
                low == "date"
                and self.i + 1 < len(self.toks)
                and self.toks[self.i + 1][0] == "string"
            )
            if low not in ("true", "false", "null") and not is_date_literal:
                self.next()
                return E.Col(val)
        return E.Lit(self._literal())

    def _literal(self):
        kind, val = self.next()
        if kind == "op" and val == "-":
            k2, v2 = self.next()
            if k2 != "number":
                raise HyperspaceException(f"Expected number after '-', got {v2!r}")
            return -(float(v2) if "." in v2 else int(v2))
        if kind == "number":
            return float(val) if "." in val else int(val)
        if kind == "string":
            return val[1:-1].replace("''", "'")
        if kind == "ident":
            low = val.lower()
            if low == "true":
                return True
            if low == "false":
                return False
            if low == "null":
                return None
            if low == "date":
                k2, v2 = self.next()
                if k2 != "string":
                    raise HyperspaceException("DATE takes a quoted literal")
                import numpy as np

                # same doubled-quote unescape as plain string literals
                return np.datetime64(v2[1:-1].replace("''", "'"))
        raise HyperspaceException(f"Expected literal, got {val!r}")


def parse_sql(session, sql: str, catalog) -> "Any":
    """Parse one SELECT statement into a DataFrame over the catalog."""
    return _Parser(sql).parse(session, catalog)
