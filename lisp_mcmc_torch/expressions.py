"""Posterior-expression evaluation: derived quantities from fitted params.

The port's own copy of ``lisp_mcmc_tpu/expressions.py`` (numpy; the port
imports nothing of the JAX package).  It rebuilds ``walker-with-exp`` (mcmc-fitting.lisp:1052-1064) and its macro
sibling ``walker-get-f`` (1039): walk an expression, substitute ``:keyword``
parameters with their most-likely values, evaluate.  Reference uses:
``(walker-with-exp woi '(/ :linewidth :x0))`` (test.lisp:31) and
``(/ (- :mu2 :mu1) 2 2.8)`` (nv-specific.lisp:68-69).

Two input syntaxes are accepted:
  - Lisp-style s-expressions, e.g. ``"(/ (- :mu2 :mu1) 2 2.8)"`` — parsed
    and evaluated by a small safe interpreter (no ``eval``);
  - Python expressions with ``:name`` parameter references, e.g.
    ``":linewidth / :x0"`` — parsed with ``ast`` and interpreted by a
    node-type-whitelist evaluator (no ``eval`` anywhere: arithmetic,
    comparisons, numeric literals, and whitelisted math calls only; no
    attribute access, so sandbox escapes are structurally impossible).

Both evaluators are numpy-vectorized, so the same expression evaluates at
a point (``walker_with_expression``) or over the whole retained posterior
(``expression_samples`` — the distribution of the derived quantity, a
capability the single-point reference verb could not offer).
"""

from __future__ import annotations

import ast
import functools
import operator
import re
from typing import Mapping

import numpy as np

__all__ = [
    "eval_expression",
    "walker_with_expression",
    "expression_samples",
    "expression_credible_interval",
    "expression_hdi",
]

_SEXP_OPS = {
    "+": lambda *a: functools.reduce(np.add, a),
    "-": lambda *a: functools.reduce(np.subtract, a) if len(a) > 1 else np.negative(a[0]),
    "*": lambda *a: functools.reduce(np.multiply, a),
    "/": lambda *a: functools.reduce(np.divide, a) if len(a) > 1 else np.divide(1.0, a[0]),
    "expt": np.power,
    "exp": np.exp,
    "log": lambda a, *b: np.log(a) / np.log(b[0]) if b else np.log(a),
    "sqrt": np.sqrt,
    "sin": np.sin,
    "cos": np.cos,
    "tan": np.tan,
    "abs": np.abs,
    "min": lambda *a: functools.reduce(np.minimum, a),
    "max": lambda *a: functools.reduce(np.maximum, a),
    "floor": np.floor,
    "mod": np.mod,
}

_MATH_NS = {
    "exp": np.exp, "log": np.log, "sqrt": np.sqrt, "sin": np.sin,
    "cos": np.cos, "tan": np.tan, "floor": np.floor, "ceil": np.ceil,
    "abs": np.abs,
    # Variadic reductions, NOT the raw binary ufuncs: np.minimum(a, b, c)
    # treats c as the ufunc `out` argument — silently overwriting it on
    # arrays, TypeError on scalars.
    "min": lambda *a: functools.reduce(np.minimum, a),
    "max": lambda *a: functools.reduce(np.maximum, a),
    "pi": np.pi, "e": np.e,
}


def _tokenize_sexp(text: str) -> list[str]:
    return text.replace("(", " ( ").replace(")", " ) ").split()


def _parse_sexp(tokens: list[str]):
    if not tokens:
        raise ValueError("unexpected end of expression")
    tok = tokens.pop(0)
    if tok == "(":
        expr = []
        while tokens and tokens[0] != ")":
            expr.append(_parse_sexp(tokens))
        if not tokens:
            raise ValueError("missing closing paren")
        tokens.pop(0)
        return expr
    if tok == ")":
        raise ValueError("unexpected )")
    return tok


def _eval_sexp(node, params: Mapping):
    if isinstance(node, list):
        if not node:
            raise ValueError("empty expression")
        op = node[0]
        if not isinstance(op, str) or op.lower() not in _SEXP_OPS:
            raise ValueError(f"unknown operator {op!r}")
        args = [_eval_sexp(a, params) for a in node[1:]]
        return _SEXP_OPS[op.lower()](*args)
    if isinstance(node, str):
        if node.startswith(":"):
            key = node[1:]
            if key not in params:
                raise KeyError(f"unknown parameter :{key}")
            return np.asarray(params[key], dtype=np.float64)
        try:
            return float(node)
        except ValueError:
            pass
        try:
            # Common Lisp double-float literals (1d-5, 4.4D-5) — the
            # reference's own expressions use the d exponent marker.
            return float(node.replace("d", "e").replace("D", "E"))
        except ValueError:
            raise ValueError(f"unknown atom {node!r}") from None
    return float(node)


def _evaluate(expr: str, params: Mapping):
    expr = expr.strip()
    if expr.startswith("("):
        tokens = _tokenize_sexp(expr)
        tree = _parse_sexp(tokens)
        if tokens:
            raise ValueError(f"trailing tokens in expression: {tokens}")
        return _eval_sexp(tree, params)
    # Python style: substitute :name -> namespace lookup, then eval with
    # empty builtins + the numpy math whitelist.
    names = {}

    def sub(match):
        key = match.group(1)
        if key not in params:
            raise KeyError(f"unknown parameter :{key}")
        names[f"_p_{key}"] = np.asarray(params[key], dtype=np.float64)
        return f"_p_{key}"

    substituted = re.sub(r":([A-Za-z_][A-Za-z0-9_]*)", sub, expr)
    return _eval_python_ast(substituted, expr, {**_MATH_NS, **names}, params)


# AST-whitelist evaluator for the Python-expression path.  Not ``eval``:
# only arithmetic nodes, numeric constants, whitelisted names, and calls
# to whitelisted math functions are interpreted — in particular there is
# no Attribute node, so ``"().__class__.__bases__..."``-style sandbox
# escapes are structurally impossible (they raise ValueError at parse
# walk time).
_BINOPS = {
    ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
    ast.Div: operator.truediv, ast.Pow: operator.pow, ast.Mod: operator.mod,
    ast.FloorDiv: operator.floordiv,
}
_UNARYOPS = {ast.USub: operator.neg, ast.UAdd: operator.pos}
_CMPOPS = {
    ast.Lt: operator.lt, ast.LtE: operator.le, ast.Gt: operator.gt,
    ast.GtE: operator.ge, ast.Eq: operator.eq, ast.NotEq: operator.ne,
}


def _eval_python_ast(source: str, original: str, namespace: Mapping,
                     params: Mapping):
    try:
        tree = ast.parse(source, mode="eval")
    except SyntaxError as e:
        raise ValueError(f"invalid expression {original!r}: {e}") from None

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant):
            if isinstance(node.value, (int, float)) and not isinstance(node.value, bool):
                return node.value
            raise ValueError(
                f"non-numeric constant {node.value!r} in expression {original!r}")
        if isinstance(node, ast.Name):
            if node.id in namespace:
                return namespace[node.id]
            raise ValueError(
                f"unknown name {node.id!r} in expression {original!r}; "
                f"available: math functions and :{', :'.join(params)}")
        if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
            return _BINOPS[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp) and type(node.op) in _UNARYOPS:
            return _UNARYOPS[type(node.op)](ev(node.operand))
        if isinstance(node, ast.Compare):
            left = ev(node.left)
            out = True
            for op, comp in zip(node.ops, node.comparators):
                if type(op) not in _CMPOPS:
                    raise ValueError(
                        f"unsupported comparison in expression {original!r}")
                right = ev(comp)
                out = np.logical_and(out, _CMPOPS[type(op)](left, right))
                left = right
            return out
        if isinstance(node, ast.Call):
            if node.keywords or not isinstance(node.func, ast.Name):
                raise ValueError(
                    f"unsupported call in expression {original!r}")
            fn = node.func.id
            if fn not in _MATH_NS or not callable(_MATH_NS[fn]):
                raise ValueError(
                    f"unknown function {fn!r} in expression {original!r}")
            return _MATH_NS[fn](*[ev(a) for a in node.args])
        raise ValueError(
            f"unsupported syntax ({type(node).__name__}) in expression "
            f"{original!r}: only arithmetic, comparisons, numeric literals, "
            f"and whitelisted math functions are allowed")

    return ev(tree)


def eval_expression(expr: str, params: Mapping) -> float:
    """Evaluate an expression against a parameter dict of scalars.

    S-expression form if it starts with ``(``; otherwise a Python
    expression where ``:name`` references substitute parameter values.
    """
    return float(_evaluate(expr, params))


def walker_with_expression(walker, expr: str, take: int | None = 1000) -> float:
    """``walker-with-exp`` (mcmc-fitting.lisp:1052-1064): evaluate ``expr``
    at the walker's most-likely parameters."""
    params = walker.most_likely_params()
    del take  # most-likely tracking is exact over the whole run here
    return eval_expression(expr, params)


def expression_samples(walker, expr: str, take: int | None = 1000) -> np.ndarray:
    """The posterior *distribution* of a derived quantity.

    Evaluates ``expr`` over every retained posterior sample (flattened
    across walkers), e.g. the spread of an NV field offset.  The
    reference's verb evaluated only the single most-likely point.
    """
    pos, _ = walker._history(take)
    flat = pos.reshape(-1, walker.ndim)
    params = {k: flat[:, i] for i, k in enumerate(walker.spec.keys)}
    return np.asarray(_evaluate(expr, params), dtype=np.float64)


def expression_credible_interval(walker, expr: str, take: int | None = 1000,
                                 level: float = 0.95):
    """(median, low, high) central credible interval of a derived quantity."""
    samples = expression_samples(walker, expr, take)
    tail = 100.0 * (1.0 - level) / 2.0
    return (
        float(np.median(samples)),
        float(np.percentile(samples, tail)),
        float(np.percentile(samples, 100.0 - tail)),
    )


def expression_hdi(walker, expr: str, take: int | None = 1000,
                   level: float = 0.95):
    """(median, low, high) HIGHEST-DENSITY interval of a derived quantity.

    The shortest interval holding ``level`` of the posterior — the right
    summary when the derived quantity's posterior is skewed (e.g. a
    rate ``1/tau``), where the central interval trades high-density
    points for long-tail ones; see :func:`lisp_mcmc_torch.stats.hdi`.
    """
    from .stats import hdi

    samples = expression_samples(walker, expr, take)
    lo, hi = hdi(samples, level)
    return float(np.median(samples)), lo, hi
