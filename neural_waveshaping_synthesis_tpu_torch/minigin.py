"""minigin — a small gin-config-compatible configuration subsystem.

The port's own copy of the JAX package's ``minigin`` (the port imports
nothing of that package), with its own registry: the port's configurables
register here, so the repo's ``.gin`` files (``gin/train/train_newt.gin``,
``gin/models/newt.gin``) bind the port's classes by the same names. The
reference's config layer is gin-config 0.4.0; this reimplements the subset
those files use, with the same syntax and the familiar API:

    @minigin.configurable            — register a class/function
    minigin.external_configurable    — register a third-party callable
    minigin.parse_config_file(path)  — load bindings from a .gin file
    minigin.parse_config(str)        — load bindings from a string
    minigin.constant(name, value)    — define a %macro at runtime
    minigin.config_scope(name)       — scoped-binding context manager
    minigin.bind_parameter / query_parameter / clear_config

Semantics notes:
  * bindings apply as *default* keyword values: explicit call-site
    arguments win over config, config wins over declared defaults.
  * ``@Name`` injects the registered callable itself; ``@Name()``
    calls it (lazily, at injection time); both honor ``scope/Name``.
  * scope resolution: a binding ``s/Class.param`` applies only when the
    configurable is constructed inside ``with config_scope("s")``, and
    takes precedence over the unscoped ``Class.param``.
"""
from __future__ import annotations

import ast
import contextlib
import os
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

_REGISTRY: Dict[str, Callable] = {}
_BINDINGS: Dict[Tuple[str, str, str], Any] = {}  # (scope, name, param) -> value
_MACROS: Dict[str, Any] = {}
_SCOPE_STACK = threading.local()


class ConfigError(Exception):
    pass


# ---------------------------------------------------------------------------
# scope stack
# ---------------------------------------------------------------------------
def _scopes() -> List[str]:
    if not hasattr(_SCOPE_STACK, "stack"):
        _SCOPE_STACK.stack = []
    return _SCOPE_STACK.stack


@contextlib.contextmanager
def config_scope(name: str):
    _scopes().append(name)
    try:
        yield
    finally:
        _scopes().pop()


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------
def _register(obj: Callable, name: str) -> None:
    _REGISTRY[name] = obj


def _merge_bindings(name: str, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Config-bound params for `name` under the active scopes, with
    call-site kwargs taking precedence."""
    merged: Dict[str, Any] = {}
    # unscoped first, then active scopes innermost-last (higher priority)
    layers = [""] + _scopes()
    for scope in layers:
        for (s, n, param), value in _BINDINGS.items():
            if s == scope and n == name:
                merged[param] = _resolve(value)
    merged.update(kwargs)
    return merged


class _ConfigurableReference:
    """An ``@Name`` or ``@scope/Name`` value in a config file."""

    def __init__(self, target: str, evaluate: bool):
        self.scope, _, self.name = target.rpartition("/")
        self.evaluate = evaluate

    def resolve(self):
        if self.name not in _REGISTRY:
            raise ConfigError(f"@{self.name} is not a registered configurable")
        fn = _REGISTRY[self.name]
        if self.scope:
            scope = self.scope

            def scoped(*args, _fn=fn, **kwargs):
                with config_scope(scope):
                    return _fn(*args, **kwargs)

            scoped.__name__ = getattr(fn, "__name__", self.name)
            fn = scoped
        return fn() if self.evaluate else fn


class _Macro:
    def __init__(self, name: str):
        self.name = name

    def resolve(self):
        if self.name not in _MACROS:
            raise ConfigError(f"%{self.name} is not a defined macro/constant")
        return _resolve(_MACROS[self.name])


class _Expr:
    """Lazy arithmetic over macros/references, e.g. ``2 * %sample_rate``;
    resolved at injection time so macro definition order doesn't matter."""

    _OPS = {
        "*": lambda a, b: a * b,
        "+": lambda a, b: a + b,
        "-": lambda a, b: a - b,
        "/": lambda a, b: a / b,
    }

    def __init__(self, op: str, left: Any, right: Any):
        self.op, self.left, self.right = op, left, right

    def resolve(self):
        return self._OPS[self.op](_resolve(self.left), _resolve(self.right))


def _resolve(value: Any) -> Any:
    if isinstance(value, (_ConfigurableReference, _Macro, _Expr)):
        return value.resolve()
    if isinstance(value, list):
        return [_resolve(v) for v in value]
    if isinstance(value, tuple):
        return tuple(_resolve(v) for v in value)
    if isinstance(value, dict):
        return {k: _resolve(v) for k, v in value.items()}
    return value


def configurable(obj: Optional[Callable] = None, name: Optional[str] = None):
    """Register a function or class; injected bindings become defaults."""

    def wrap(target: Callable):
        reg_name = name or target.__name__
        if isinstance(target, type):
            orig_init = target.__init__

            def __init__(self, *args, **kwargs):  # noqa: N807
                orig_init(self, *args, **_merge_bindings(reg_name, kwargs))

            wrapped = type(target.__name__, (target,), {"__init__": __init__})
            wrapped.__module__ = target.__module__
            wrapped.__qualname__ = target.__qualname__
            wrapped.__doc__ = target.__doc__
            wrapped.__gin_original__ = target
            _register(wrapped, reg_name)
            return wrapped
        else:

            def wrapper(*args, **kwargs):
                return target(*args, **_merge_bindings(reg_name, kwargs))

            wrapper.__name__ = target.__name__
            wrapper.__qualname__ = target.__qualname__
            wrapper.__doc__ = target.__doc__
            wrapper.__wrapped__ = target
            _register(wrapper, reg_name)
            return wrapper

    if obj is not None:
        return wrap(obj)
    return wrap


def external_configurable(obj: Callable, name: Optional[str] = None, module: str = ""):
    """Register a third-party callable (reference registers torch.nn.GRU /
    Conv1d this way, neural_waveshaping.py:13-14)."""
    return configurable(obj, name=name or obj.__name__)


def constant(name: str, value: Any) -> None:
    _MACROS[name] = value


def bind_parameter(target: str, value: Any) -> None:
    scope, _, rest = target.rpartition("/")
    name, _, param = rest.rpartition(".")
    if not name:
        raise ConfigError(f"bind_parameter target must be Class.param, got {target!r}")
    _BINDINGS[(scope, name, param)] = value


def query_parameter(target: str) -> Any:
    scope, _, rest = target.rpartition("/")
    name, _, param = rest.rpartition(".")
    if not name:  # macro query
        return _resolve(_MACROS[rest])
    return _resolve(_BINDINGS[(scope, name, param)])


def clear_config() -> None:
    _BINDINGS.clear()
    _MACROS.clear()


def validate_config(strict: bool = False) -> List[str]:
    """Surface bindings that can never take effect.

    Like gin, bindings are deferred — a typo'd configurable or parameter
    name is a SILENT no-op at parse time. Call this after all modules
    have imported (the CLIs do, post-parse) to catch:
      * bindings whose configurable name is not registered;
      * bindings naming a parameter the configurable doesn't accept
        (skipped for **kwargs signatures).

    ORDERING CONTRACT: registration happens at import time, so this
    must run AFTER every module that registers a bound configurable is
    imported — validating too early flags valid bindings as unknown
    (warnings in default mode, spurious ConfigError in strict). CLIs
    should import their model/training modules first, the way
    scripts/torch_train.py does.

    Returns the list of problem descriptions; prints each as a warning,
    and raises ConfigError instead when ``strict``.
    """
    import inspect
    import sys

    problems: List[str] = []
    for scope, name, param in _BINDINGS:
        fn = _REGISTRY.get(name)
        full = f"{scope + '/' if scope else ''}{name}.{param}"
        if fn is None:
            problems.append(
                f"binding {full!r}: no configurable named {name!r} is registered"
            )
            continue
        target = (
            getattr(fn, "__gin_original__", None)
            or getattr(fn, "__wrapped__", None)
            or fn
        )
        try:
            sig = inspect.signature(target)
        except (TypeError, ValueError):
            continue
        if any(
            p.kind is inspect.Parameter.VAR_KEYWORD
            for p in sig.parameters.values()
        ):
            continue
        if param not in sig.parameters:
            problems.append(
                f"binding {full!r}: {name!r} has no parameter {param!r}"
            )
    if problems and strict:
        raise ConfigError("; ".join(problems))
    for p in problems:
        print(f"[minigin] WARNING: {p}", file=sys.stderr)
    return problems


# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------
_TOKEN_RE = re.compile(
    r"""('(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")   # quoted strings
      | (@[\w./]+\(\))                          # evaluated reference
      | (@[\w./]+)                              # reference
      | (%[\w.]+)                               # macro
    """,
    re.VERBOSE,
)


def _parse_value(text: str) -> Any:
    """Parse a gin RHS: python literal with @ref / %macro substitution."""
    text = text.strip()
    placeholders: List[Any] = []

    def sub(match):
        s, ref_eval, ref, macro = match.groups()
        if s is not None:
            return s
        if ref_eval is not None:
            placeholders.append(_ConfigurableReference(ref_eval[1:-2], evaluate=True))
        elif ref is not None:
            placeholders.append(_ConfigurableReference(ref[1:], evaluate=False))
        else:
            placeholders.append(_Macro(macro[1:]))
        return f"__MINIGIN_{len(placeholders) - 1}__"

    substituted = _TOKEN_RE.sub(sub, text)
    node = ast.parse(substituted, mode="eval").body

    def build(n):
        if isinstance(n, ast.Constant):
            return n.value
        if isinstance(n, ast.Name):
            m = re.fullmatch(r"__MINIGIN_(\d+)__", n.id)
            if m:
                return placeholders[int(m.group(1))]
            if n.id in ("None", "True", "False"):
                return {"None": None, "True": True, "False": False}[n.id]
            raise ConfigError(f"unsupported name in config value: {n.id!r}")
        if isinstance(n, ast.List):
            return [build(e) for e in n.elts]
        if isinstance(n, ast.Tuple):
            return tuple(build(e) for e in n.elts)
        if isinstance(n, ast.Dict):
            return {build(k): build(v) for k, v in zip(n.keys, n.values)}
        if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.USub):
            return -build(n.operand)
        if isinstance(n, ast.BinOp):  # e.g. 2 * %sample_rate
            op_name = {
                ast.Mult: "*",
                ast.Add: "+",
                ast.Sub: "-",
                ast.Div: "/",
            }.get(type(n.op))
            if op_name is not None:
                return _Expr(op_name, build(n.left), build(n.right))
        raise ConfigError(f"unsupported config value syntax: {text!r}")

    return build(node)


def parse_config(text: str, base_dir: str = ".") -> None:
    """Parse gin-syntax bindings from a string."""
    # join continuation lines (unbalanced brackets)
    lines: List[str] = []
    buf = ""
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        buf = f"{buf} {line}" if buf else line
        if buf.count("(") + buf.count("[") + buf.count("{") > buf.count(
            ")"
        ) + buf.count("]") + buf.count("}"):
            continue
        lines.append(buf.strip())
        buf = ""
    if buf:
        lines.append(buf.strip())

    for line in lines:
        if line.startswith("include"):
            m = re.match(r"include\s+['\"](.+)['\"]", line)
            if not m:
                raise ConfigError(f"malformed include: {line!r}")
            parse_config_file(_find_include(m.group(1), base_dir))
            continue
        if "=" not in line:
            raise ConfigError(f"malformed config line: {line!r}")
        target, value_text = line.split("=", 1)
        target = target.strip()
        value = _parse_value(value_text)
        if "." in target:
            bind_parameter(target, value)
        else:
            _MACROS[target] = value


def _find_include(path: str, base_dir: str) -> str:
    """gin resolves includes relative to CWD; we also try the including
    file's directory and the repo root so configs work from anywhere."""
    candidates = [
        path,
        os.path.join(base_dir, path),
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), path),
        os.path.join(os.path.dirname(os.path.dirname(__file__)), path),
    ]
    for c in candidates:
        if os.path.exists(c):
            return c
    raise ConfigError(f"include not found: {path!r} (tried {candidates})")


def parse_config_file(path: str) -> None:
    """Parse a .gin file. Relative paths resolve against the CWD first,
    then the repo root — so CLIs work from any directory with the
    shipped ``gin/...`` defaults."""
    if not os.path.exists(path) and not os.path.isabs(path):
        repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        candidate = os.path.join(repo_root, path)
        if os.path.exists(candidate):
            path = candidate
    with open(path) as f:
        parse_config(f.read(), base_dir=os.path.dirname(os.path.abspath(path)))


def _render(value: Any) -> str:
    if isinstance(value, _ConfigurableReference):
        prefix = f"{value.scope}/" if value.scope else ""
        return f"@{prefix}{value.name}" + ("()" if value.evaluate else "")
    if isinstance(value, _Macro):
        return f"%{value.name}"
    if isinstance(value, _Expr):
        return f"{_render(value.left)} {value.op} {_render(value.right)}"
    return repr(value)


def operative_config_str() -> str:
    """Human-readable dump of active bindings (for run logging)."""
    out = []
    for name, value in sorted(_MACROS.items()):
        out.append(f"{name} = {_render(value)}")
    for (scope, name, param), value in sorted(_BINDINGS.items()):
        prefix = f"{scope}/" if scope else ""
        out.append(f"{prefix}{name}.{param} = {_render(value)}")
    return "\n".join(out)
