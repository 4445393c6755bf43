"""Math-expression compiler: input-deck expression strings -> PyTorch
functions.

The counterpart of ``warpx_tpu.utils.expression`` (reference:
Source/Utils/Parser/ParserUtils.{H,cpp}, amrex::Parser).  An expression
string is translated to a Python expression evaluated in a namespace of
``torch`` functions, giving a function of its declared variables that runs
on whatever device its tensor arguments live on.

Supported syntax (the JAX package's): +,-,*,/,** (also '^'), comparisons
(0/1 values), sqrt, sin, cos, tan, asin, acos, atan, atan2, sinh, cosh, tanh,
exp, log, log10, pow, abs/fabs, floor, ceil, min, max, fmod, erf,
heaviside(x, x0), sign, if(cond, a, b), and/or/not (on 0/1 values), and the
``name = expr; ...; final`` assignment chains of amrex::Parser.
"""

from __future__ import annotations

import ast
import math
import re
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from .. import constants

__all__ = ["compile_expression", "evaluate_constant"]


def _t(x):
    """``x`` as a tensor (a Python number becomes a float64 0-d tensor)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        x, dtype=torch.float64)


def _heaviside(x, x0):
    x = _t(x)
    return torch.where(x < 0, 0.0, torch.where(x > 0, 1.0, _t(x0).to(x)))


def _if(cond, a, b):
    cond = _t(cond)
    return torch.where(cond != 0, _t(a).to(cond.device),
                       _t(b).to(cond.device))


def _unary(fn):
    return lambda a: fn(_t(a))


def _binary(fn):
    return lambda a, b: fn(_t(a), _t(b))


_FUNCS = {
    "sqrt": _unary(torch.sqrt),
    "sin": _unary(torch.sin),
    "cos": _unary(torch.cos),
    "tan": _unary(torch.tan),
    "asin": _unary(torch.arcsin),
    "acos": _unary(torch.arccos),
    "atan": _unary(torch.arctan),
    "atan2": _binary(torch.atan2),
    "sinh": _unary(torch.sinh),
    "cosh": _unary(torch.cosh),
    "tanh": _unary(torch.tanh),
    "exp": _unary(torch.exp),
    "log": _unary(torch.log),
    "log10": _unary(torch.log10),
    "pow": _binary(torch.pow),
    "abs": _unary(torch.abs),
    "fabs": _unary(torch.abs),
    "floor": _unary(torch.floor),
    "ceil": _unary(torch.ceil),
    "min": _binary(torch.minimum),
    "max": _binary(torch.maximum),
    "fmod": _binary(torch.fmod),
    "erf": _unary(torch.special.erf),
    "heaviside": _heaviside,
    "sign": _unary(torch.sign),
    "where": _if,  # target of the if() rewrite
    "logand": _binary(torch.logical_and),
    "logor": _binary(torch.logical_or),
    "lognot": _unary(torch.logical_not),
}

# 'if' is a Python keyword: rewrite calls "if(" -> "where(".
_IF_RE = re.compile(r"\bif\s*\(")


def _translate(expr: str) -> str:
    s = expr.strip().replace("\n", " ")
    s = s.replace("^", "**")
    # and/or/not keep Python's loose precedence (a<b and c>d parses as
    # (a<b) and (c>d)); the AST pass in compile_expression turns them into
    # logical calls
    return _IF_RE.sub("where(", s)


class _Floats(ast.NodeTransformer):
    """Float literals -> names ``_k<i>``, bound at each call to 0-d tensors
    of the arguments' type: a comparison gives a bool tensor, and a Python
    float times a bool tensor would be computed in torch's default float32
    where the JAX package computes in the state's type."""

    def __init__(self):
        self.values = []

    def visit_Constant(self, node):
        if not isinstance(node.value, float):
            return node
        self.values.append(node.value)
        return ast.Name(id=f"_k{len(self.values) - 1}", ctx=ast.Load())


class _Bool(ast.NodeTransformer):
    """and/or/not -> logand/logor/lognot calls (elementwise on tensors)."""

    def visit_BoolOp(self, node):
        self.generic_visit(node)
        fn = "logand" if isinstance(node.op, ast.And) else "logor"
        out = node.values[0]
        for v in node.values[1:]:
            out = ast.Call(func=ast.Name(id=fn, ctx=ast.Load()),
                           args=[out, v], keywords=[])
        return out

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return ast.Call(func=ast.Name(id="lognot", ctx=ast.Load()),
                            args=[node.operand], keywords=[])
        return node


def compile_expression(
    expr: str,
    variables: Sequence[str],
    user_constants: Mapping[str, float] | None = None,
) -> Callable:
    """Compile ``expr`` into ``f(*variables) -> torch.Tensor``.

    The arguments may be tensors, numpy arrays or numbers.  The result has
    the arguments' broadcast shape, lives on their device and has the
    floating type of the first floating tensor argument (float64 for numpy
    arrays and numbers).
    """
    if ";" in expr:
        segments = [s.strip() for s in expr.split(";") if s.strip()]
        assigns = []
        names = list(variables)
        for seg in segments[:-1]:
            m = re.match(r"^([A-Za-z_]\w*)\s*=(?!=)\s*(.+)$", seg)
            if not m:
                raise ValueError(
                    f"expected 'name = expr' segment, got {seg!r}")
            assigns.append(
                compile_expression(m.group(2), tuple(names), user_constants))
            names.append(m.group(1))
        final = compile_expression(segments[-1], tuple(names), user_constants)

        def chained(*args):
            vals = list(args)
            for fn in assigns:
                vals.append(fn(*vals))
            return final(*vals)

        return chained
    if "__" in expr:
        # physics expressions never need dunders; refusing them keeps the
        # restricted eval safe while __import__ stays available for the
        # imports torch makes from C++ inside the eval frame
        raise ValueError(f"invalid deck expression: {expr!r}")
    namespace: dict = dict(_FUNCS)
    namespace["__builtins__"] = {"__import__": __import__}
    named = dict(constants.EXPRESSION_CONSTANTS)
    named.update(user_constants or {})
    floats = _Floats()
    tree = ast.fix_missing_locations(_Bool().visit(
        floats.visit(ast.parse(_translate(expr), mode="eval"))))
    code = compile(tree, f"<deck-expr: {expr[:60]}>", "eval")
    named.update({f"_k{i}": v for i, v in enumerate(floats.values)})

    def fn(*args):
        args = [torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray)
                else a for a in args]
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        types = [a.dtype for a in tensors if a.is_floating_point()]
        dtype = types[0] if types else torch.float64
        device = tensors[0].device if tensors else torch.device("cpu")
        shape = torch.broadcast_shapes(*[a.shape for a in tensors])
        local = {k: torch.tensor(v, dtype=dtype, device=device)
                 for k, v in named.items()}
        local.update(zip(variables, args))
        out = eval(code, namespace, local)  # noqa: S307
        return _t(out).to(device=device, dtype=dtype) + torch.zeros(
            shape, dtype=dtype, device=device)

    fn.__name__ = "deck_expr"
    fn.expression = expr
    return fn


def evaluate_constant(
    expr: str, user_constants: Mapping[str, float] | None = None
) -> float:
    """Evaluate a variable-free deck expression to a Python float on the
    host."""
    namespace: dict = {
        "sqrt": math.sqrt,
        "sin": math.sin,
        "cos": math.cos,
        "tan": math.tan,
        "asin": math.asin,
        "acos": math.acos,
        "atan": math.atan,
        "atan2": math.atan2,
        "sinh": math.sinh,
        "cosh": math.cosh,
        "tanh": math.tanh,
        "exp": math.exp,
        "log": math.log,
        "log10": math.log10,
        "pow": math.pow,
        "abs": abs,
        "fabs": abs,
        "floor": math.floor,
        "ceil": math.ceil,
        "min": min,
        "max": max,
        "fmod": math.fmod,
        "erf": math.erf,
        "sign": lambda x: (x > 0) - (x < 0),
        "heaviside": lambda x, x0: 0.0 if x < 0 else (1.0 if x > 0 else x0),
        "where": lambda c, a, b: a if c else b,
    }
    namespace.update(constants.EXPRESSION_CONSTANTS)
    if user_constants:
        namespace.update(user_constants)
    namespace["__builtins__"] = {}
    return float(eval(_translate(expr), namespace, {}))  # noqa: S307
