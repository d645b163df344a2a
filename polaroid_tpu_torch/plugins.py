"""Expression-plugin registration.

Capability analogue of the reference's `polars.plugins`
(`py-polars/src/polars/plugins.py:24` register_plugin_function, backed by
Rust dylibs over the stable FFI in `polars-ffi`/`pyo3-polars`). This
engine's expression boundary is Python/torch, so plugins here are Python
callables registered under a (namespace, name) key: each receives the
evaluated input columns as Series and returns a Series. Rust dylib paths
are rejected with a clear error rather than silently ignored.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

__all__ = ["register_plugin_function", "register_plugin_callable",
           "get_plugin"]

_PLUGINS: Dict[Tuple[str, str], Callable] = {}


def register_plugin_callable(name: str, function: Callable,
                             namespace: str = "") -> None:
    """Register a Python callable as an expression plugin. The callable
    receives one Series per input expression and returns a Series (or a
    list/numpy array)."""
    _PLUGINS[(namespace, name)] = function


def get_plugin(name: str, namespace: str = ""):
    return _PLUGINS.get((namespace, name))


def register_plugin_function(
        *, plugin_path=None, function_name: str,
        args: Sequence[Any] = (), kwargs=None,
        is_elementwise: bool = False, changes_length: bool = False,
        returns_scalar: bool = False, cast_to_supertype: bool = False,
        input_wildcard_expansion: bool = False,
        pass_name_to_apply: bool = False, **_ignored):
    """Create an expression that calls a registered plugin function
    (reference: `py-polars/src/polars/plugins.py:24`). `plugin_path` is
    accepted for signature parity; compiled dylib plugins are not
    loadable here — register a Python callable with
    `register_plugin_callable` first."""
    from .errors import InvalidOperationError
    from .expr.expr import Expr, _wrap_col

    fn = get_plugin(function_name)
    if fn is None:
        raise InvalidOperationError(
            f"plugin function {function_name!r} is not registered; this "
            "engine loads Python plugins via "
            "polaroid_tpu_torch.plugins.register_plugin_callable (compiled "
            f"dylib plugins from {plugin_path!r} are not supported)")
    kw = dict(kwargs or {})
    es = tuple(_wrap_col(a) for a in args)

    def apply(series_list):
        return fn(*series_list, **kw)

    if returns_scalar or not changes_length:
        # elementwise/broadcast plugin: run over the whole column batch
        if len(es) == 1 and is_elementwise:
            return es[0].map_batches(lambda d: fn(d, **kw))
    return Expr("map_groups_udf", es, fn=apply, return_dtype=None,
                returns_scalar=returns_scalar)
