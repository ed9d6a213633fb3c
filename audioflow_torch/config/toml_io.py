"""Minimal TOML emit/parse (stdlib tomllib reads; we emit a compatible subset).

The emitter covers what the config tree needs: nested tables of scalars,
strings, booleans, lists of scalars, and lists of inline tables.
"""

from __future__ import annotations

import tomllib
from typing import Any, Mapping


def loads_toml(text: str) -> dict:
    return tomllib.loads(text)


def _scalar(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if v is None:
        raise ValueError("TOML has no null; drop None keys before emitting")
    raise TypeError(f"unsupported TOML scalar {type(v).__name__}")


def _inline(v: Mapping) -> str:
    return "{ " + ", ".join(f"{k} = {_emit_value(x)}" for k, x in v.items()) + " }"


def _emit_value(v: Any) -> str:
    if isinstance(v, Mapping):
        return _inline(v)
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_emit_value(x) for x in v) + "]"
    return _scalar(v)


def dumps_toml(data: Mapping, _prefix: str = "") -> str:
    """Emit a nested mapping as TOML (scalars first, then sub-tables)."""
    lines: list[str] = []
    tables: list[tuple[str, Mapping]] = []
    for k, v in data.items():
        if v is None:
            continue
        if isinstance(v, Mapping):
            tables.append((k, v))
        else:
            lines.append(f"{k} = {_emit_value(v)}")
    out = "\n".join(lines)
    for k, v in tables:
        name = f"{_prefix}{k}"
        body = dumps_toml(v, _prefix=name + ".")
        out += f"\n\n[{name}]\n{body}" if out else f"[{name}]\n{body}"
    return out.strip() + "\n"
