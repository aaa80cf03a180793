"""Arithmetic filter expressions — the tinyexpr analog used by
filterdb --filter-expression (lib/mmseqs/src/commons/ExpressionParser.cpp,
lib/tinyexpr/tinyexpr.c).

Grammar: numbers, `$N` (1-based line column, bound as float via strtod
semantics), `+ - * / % ^`, comparisons `< > <= >= == !=`, logicals
`&& || !`, parentheses, and tinyexpr's function set (abs, ceil, exp,
floor, ln, log, log10, pow, sqrt, fmod, plus trig).  A line is kept when
the expression evaluates non-zero (filterdb.cpp:357-372).

Implemented by rewriting to a Python expression and validating the AST
against a node whitelist — no arbitrary code can run.
"""

from __future__ import annotations

import ast
import math
import re

_FUNCS = {
    "abs": abs, "ceil": math.ceil, "exp": math.exp, "floor": math.floor,
    "ln": math.log, "log": math.log, "log10": math.log10, "pow": math.pow,
    "sqrt": math.sqrt, "fmod": math.fmod, "fac": math.factorial,
    "sin": math.sin, "cos": math.cos, "tan": math.tan, "atan": math.atan,
    "atan2": math.atan2, "asin": math.asin, "acos": math.acos,
    "sinh": math.sinh, "cosh": math.cosh, "tanh": math.tanh,
    "e": math.e, "pi": math.pi,
}

_ALLOWED = (ast.Expression, ast.BinOp, ast.UnaryOp, ast.BoolOp,
            ast.Compare, ast.Call, ast.Name, ast.Load, ast.Constant,
            ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Mod, ast.Pow,
            ast.USub, ast.UAdd, ast.Not, ast.And, ast.Or,
            ast.Lt, ast.Gt, ast.LtE, ast.GtE, ast.Eq, ast.NotEq)


class FilterExpression:
    def __init__(self, expression: str):
        src = expression
        src = re.sub(r"\$(\d+)", r"_c\1", src)
        src = src.replace("&&", " and ").replace("||", " or ")
        # '!' (not followed by '=') -> not
        src = re.sub(r"!(?!=)", " not ", src)
        src = src.replace("^", "**").strip()
        self._tree = ast.parse(src, mode="eval")
        for node in ast.walk(self._tree):
            if not isinstance(node, _ALLOWED):
                raise ValueError(
                    f"unsupported construct in expression: "
                    f"{type(node).__name__}")
            if (isinstance(node, ast.Call)
                    and (not isinstance(node.func, ast.Name)
                         or node.func.id not in _FUNCS)):
                raise ValueError("unknown function in expression")
        self._code = compile(self._tree, "<filter-expression>", "eval")
        self.bindable_columns = sorted(
            int(n.id[2:]) for n in ast.walk(self._tree)
            if isinstance(n, ast.Name) and n.id.startswith("_c"))

    def evaluate(self, columns: list[str]) -> float:
        env = dict(_FUNCS)
        for c in self.bindable_columns:
            if c - 1 < len(columns):
                try:
                    env[f"_c{c}"] = float(columns[c - 1])
                except ValueError:
                    env[f"_c{c}"] = 0.0   # strtod failure -> unbound (0)
            else:
                env[f"_c{c}"] = 0.0
        try:
            return float(eval(self._code, {"__builtins__": {}}, env))
        except ZeroDivisionError:
            # tinyexpr evaluates in IEEE doubles: x/0 -> inf, 0/0 -> nan
            # (the filtered line is then kept or dropped, never a crash)
            return float("nan")
