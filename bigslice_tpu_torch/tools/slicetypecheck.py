"""Static pipeline checker (the JAX package's ``tools/slicetypecheck``).

Scans Python sources for ``session.run(func, args...)`` calls and
checks them against the ``@func`` definitions found in the same file
(``@bs.func``, ``@func`` or ``@bs.func(exclusive=True)``, with
``bigslice_tpu_torch`` imported under any name). Three classes of
check:

- **arity**: too few or too many positional arguments.
- **types**: a call-site argument whose static type is inferrable (a
  literal, or a name bound once to a literal) against the Func
  parameter's annotation, so that a wrong type surfaces before
  anything runs. Unknown annotations and uninferrable arguments are
  skipped: the checker never flags dynamic code.
- **serializability**: a Func is re-invoked in each process that runs
  it instead of shipping its values, so an argument that cannot be
  re-created deterministically or cross a process boundary is flagged
  at the call site: lambdas, generator expressions and open file
  handles.

It reads source and runs nothing, so it needs no device.

Usage: python -m bigslice_tpu_torch.tools.slicetypecheck FILE [FILE...]
"""

from __future__ import annotations

import ast
import sys
from typing import Dict, List, Optional, Tuple

# Annotation dotted-name → the Python types a literal may have.
# Conservative: anything not listed is unchecked.
_ANNOT_COMPAT = {
    "int": (int,),
    "float": (int, float),  # int literals widen to float params
    "str": (str,),
    "bool": (bool,),
    "bytes": (bytes,),
    "list": (list,),
    "tuple": (tuple,),
    "dict": (dict,),
    # numpy scalar annotations accept Python number literals
    "np.int32": (int,), "numpy.int32": (int,),
    "np.int64": (int,), "numpy.int64": (int,),
    "np.float32": (int, float), "numpy.float32": (int, float),
    "np.float64": (int, float), "numpy.float64": (int, float),
    "np.ndarray": (list, tuple), "numpy.ndarray": (list, tuple),
}

_NONSERIALIZABLE = {
    ast.Lambda: "a lambda",
    ast.GeneratorExp: "a generator expression",
}


def _dotted(node) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def _literal_type(node) -> Optional[type]:
    """The static Python type of an expression, when inferrable."""
    if isinstance(node, ast.Constant):
        return type(node.value) if node.value is not None else type(None)
    if isinstance(node, ast.List):
        return list
    if isinstance(node, ast.Tuple):
        return tuple
    if isinstance(node, ast.Dict):
        return dict
    if isinstance(node, ast.UnaryOp) and isinstance(
        node.op, (ast.USub, ast.UAdd)
    ):
        return _literal_type(node.operand)
    return None


class _Collector(ast.NodeVisitor):
    def __init__(self):
        # name -> (required, total, has_vararg,
        #          [(param name, annotation dotted str)])
        self.funcs: Dict[str, Tuple[int, int, bool, list]] = {}
        # (name, [positional arg nodes], [(kw name, node)], lineno)
        self.calls: List[Tuple[str, list, list, int]] = []
        # Module-scope single-static-assignment tracking: name ->
        # literal type; None once reassigned or bound by any other
        # construct (loops, with/as, walrus, augmented assignment,
        # nested scopes) — the checker never guesses.
        self._assigned: Dict[str, Optional[type]] = {}
        self._depth = 0

    def _invalidate_target(self, tgt) -> None:
        for n in ast.walk(tgt):
            if isinstance(n, ast.Name):
                self._assigned[n.id] = None

    def visit_For(self, node):
        self._invalidate_target(node.target)
        self.generic_visit(node)

    visit_AsyncFor = visit_For

    def visit_With(self, node):
        for item in node.items:
            if item.optional_vars is not None:
                self._invalidate_target(item.optional_vars)
        self.generic_visit(node)

    visit_AsyncWith = visit_With

    def visit_AugAssign(self, node):
        self._invalidate_target(node.target)
        self.generic_visit(node)

    def visit_NamedExpr(self, node):
        self._invalidate_target(node.target)
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef):
        for dec in node.decorator_list:
            name = None
            if isinstance(dec, ast.Attribute):
                name = dec.attr
            elif isinstance(dec, ast.Name):
                name = dec.id
            elif isinstance(dec, ast.Call):
                f = dec.func
                name = f.attr if isinstance(f, ast.Attribute) else getattr(
                    f, "id", None
                )
            if name == "func":
                required = len(node.args.args) - len(node.args.defaults)
                has_var = node.args.vararg is not None
                annots = [
                    (a.arg,
                     _dotted(a.annotation) if a.annotation is not None
                     else None)
                    for a in node.args.args
                ]
                self.funcs[node.name] = (
                    required, len(node.args.args), has_var, annots
                )
        self._depth += 1
        self.generic_visit(node)
        self._depth -= 1

    def visit_Assign(self, node: ast.Assign):
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                if self._depth > 0 or tgt.id in self._assigned:
                    self._assigned[tgt.id] = None  # rebound/nested
                else:
                    self._assigned[tgt.id] = _literal_type(node.value)
            else:
                self._invalidate_target(tgt)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        f = node.func
        if (isinstance(f, ast.Attribute) and f.attr in ("run", "must")
                and node.args):
            target = node.args[0]
            if isinstance(target, ast.Name):
                self.calls.append((
                    target.id, list(node.args[1:]),
                    [(kw.arg, kw.value) for kw in node.keywords],
                    node.lineno,
                ))
        self.generic_visit(node)

    def arg_type(self, node) -> Optional[type]:
        t = _literal_type(node)
        if t is not None:
            return t
        if isinstance(node, ast.Name):
            return self._assigned.get(node.id)
        return None


def _nonserializable_reason(node) -> Optional[str]:
    for cls, label in _NONSERIALIZABLE.items():
        if isinstance(node, cls):
            return label
    if isinstance(node, ast.Call):
        callee = _dotted(node.func)
        if callee in ("open", "io.open"):
            return "an open file handle"
    return None


def check_source(src: str, filename: str = "<src>") -> List[str]:
    tree = ast.parse(src, filename)
    c = _Collector()
    c.visit(tree)
    problems = []
    for name, pos_args, kw_args, lineno in c.calls:
        sig = c.funcs.get(name)
        if sig is None:
            continue  # not a registered Func we can see
        required, total, has_var, annots = sig
        nargs = len(pos_args) + len(kw_args)
        if nargs < required or (nargs > total and not has_var):
            problems.append(
                f"{filename}:{lineno}: run({name}, ...) passes {nargs} "
                f"args; {name} takes "
                + (f"at least {required}" if has_var
                   else f"{required}" if required == total
                   else f"{required}..{total}")
            )
            continue
        # Positional args align with the parameter list; keywords match
        # their parameter BY NAME (positional alignment would check
        # them against the wrong annotations).
        by_name = dict(annots)
        checks = [
            (f"arg {i + 1}",
             annots[i][1] if i < len(annots) else None, arg)
            for i, arg in enumerate(pos_args)
        ] + [
            (f"arg {kw!r}", by_name.get(kw), arg)
            for kw, arg in kw_args
        ]
        for label, annot, arg in checks:
            reason = _nonserializable_reason(arg)
            if reason is not None:
                problems.append(
                    f"{filename}:{lineno}: run({name}, ...) {label} "
                    f"is {reason}, which cannot be re-created "
                    f"identically on every host (a Func re-invokes in "
                    f"each process)"
                )
                continue
            if annot is None:
                continue
            allowed = _ANNOT_COMPAT.get(annot)
            if allowed is None:
                continue  # unknown annotation: never false-positive
            got = c.arg_type(arg)
            if got is None or got is type(None):
                continue  # dynamic arg: unchecked
            if not issubclass(got, tuple(allowed) + (type(None),)):
                problems.append(
                    f"{filename}:{lineno}: run({name}, ...) {label} "
                    f"is {got.__name__}, but {name} declares {annot}"
                )
    return problems


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m bigslice_tpu_torch.tools.slicetypecheck "
              "FILE [FILE...]", file=sys.stderr)
        return 2
    bad = 0
    for path in argv:
        with open(path) as fp:
            for p in check_source(fp.read(), path):
                print(p)
                bad += 1
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
