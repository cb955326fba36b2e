"""Minimal TOML IO: stdlib tomllib for reading, own writer for dumping.

(The environment ships no `toml`/`tomli_w` writer; round configs are
plain tables of scalars/lists/dicts, which this covers.)
"""

from __future__ import annotations

import tomllib
from typing import Any


def load(path: str) -> dict:
    with open(path, "rb") as f:
        return tomllib.load(f)


def loads(text: str) -> dict:
    return tomllib.loads(text)


def _fmt_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        escaped = v.replace("\\", "\\\\").replace('"', '\\"')
        return f'"{escaped}"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_fmt_value(x) for x in v) + "]"
    if isinstance(v, dict):
        items = ", ".join(f"{_key(k)} = {_fmt_value(x)}" for k, x in v.items())
        return "{" + items + "}"
    if v is None:
        raise ValueError("TOML has no null; drop the key instead")
    raise TypeError(f"cannot TOML-encode {type(v)}")


def _key(k: str) -> str:
    if k and all(c.isalnum() or c in "-_" for c in k):
        return k
    return _fmt_value(str(k))


def dumps(data: dict, _prefix: str = "") -> str:
    """Emit a dict as TOML: scalars/lists first, then (dotted) sub-tables."""
    lines = []
    tables = []
    for k, v in data.items():
        if v is None:
            continue
        if isinstance(v, dict):
            tables.append((k, v))
        elif (
            isinstance(v, list)
            and v
            and all(isinstance(x, dict) for x in v)
        ):
            tables.append((k, v))
        else:
            lines.append(f"{_key(k)} = {_fmt_value(v)}")

    out = "\n".join(lines)
    for k, v in tables:
        full = f"{_prefix}{_key(k)}"
        if isinstance(v, list):  # array of tables
            for item in v:
                out += f"\n\n[[{full}]]\n"
                out += dumps(item, _prefix=f"{full}.")
        else:
            out += f"\n\n[{full}]\n"
            out += dumps(v, _prefix=f"{full}.")
    return out.strip() + "\n"


def dump(data: dict, path: str):
    with open(path, "w") as f:
        f.write(dumps(data))
