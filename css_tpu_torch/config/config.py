"""YAML + CLI configuration, schema-compatible with ``css_tpu/config/config.py``.

The port reads the reference YAMLs (Network / EMA / Optim / Lr_Scheduler /
Dataset / Training_Setting / Seed / Loss / Ramp_Scheduler / Distributed)
with a small reader of its own instead of PyYAML, for the subset they use:

* block mappings; block sequences and flow lists of scalars; ``{}``;
* comments, plain scalars, single- and double-quoted scalars;
* the ``!!python/tuple`` tag on a sequence, loaded as a tuple.

Plain scalars resolve as PyYAML's YAML 1.1 resolver does, because the
reference's values depend on it: ``weight_decay: 5e-4`` has no dot and so
stays the string ``"5e-4"`` (the driver casts with ``float()``), while
``lr: 6.4e-3`` is a float; ``yes``/``on`` are booleans, ``~`` is null,
``0x1f`` and ``010`` are integers.  Anything outside the subset (anchors,
block scalars, other tags, timestamps, nested sequences) raises
``ValueError`` with its line number rather than loading differently.
``dump_config`` writes the same subset.
"""

from __future__ import annotations

import math
import os
import re
from typing import Any, Dict, List, Tuple

__all__ = ["Config", "load_config", "dump_config", "parse_yaml", "dump_yaml"]

# PyYAML 6's implicit resolvers (yaml/resolver.py), in YAML 1.1
_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False, "NO": False,
         "true": True, "True": True, "TRUE": True, "false": False, "False": False,
         "FALSE": False, "on": True, "On": True, "ON": True, "off": False, "Off": False,
         "OFF": False}
_NULL = ("", "~", "null", "Null", "NULL")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_TUPLE_TAG = "!!python/tuple"
_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t"}   # others raise


class _Error(ValueError):
    def __init__(self, lineno: int, msg: str):
        super().__init__(f"line {lineno}: {msg}")


def _sexagesimal(value: str, cast):
    total, base = cast(0), 1
    for part in reversed(value.split(":")):
        total += cast(part) * base
        base *= 60
    return total


def _resolve_plain(text: str, lineno: int = 0) -> Any:
    """The value PyYAML's SafeLoader gives the plain scalar ``text``."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _FLOAT.match(text) or _INT.match(text):
        value = text.replace("_", "")
        sign = -1 if value[0] == "-" else 1
        value = value.lstrip("+-")
        if _FLOAT.match(text):
            value = value.lower()
            if value == ".inf":
                return sign * math.inf
            if value == ".nan":
                return math.nan
            return sign * (_sexagesimal(value, float) if ":" in value else float(value))
        if value == "0":
            return 0
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value[0] == "0":
            return sign * int(value, 8)
        return sign * (_sexagesimal(value, int) if ":" in value else int(value))
    if _TIMESTAMP.match(text):
        raise _Error(lineno, f"timestamps are not supported: {text!r}")
    if text in ("=", "<<"):
        raise _Error(lineno, f"the YAML value/merge key {text!r} is not supported")
    return text


def _strip_comment(line: str) -> str:
    """``line`` without its comment (a ``#`` at the start or after a blank,
    outside quotes) and trailing blanks."""
    quote = None
    i = 0
    while i < len(line):
        ch = line[i]
        if quote == "'":
            if ch == "'" and line[i + 1:i + 2] == "'":
                i += 1
            elif ch == "'":
                quote = None
        elif quote == '"':
            if ch == "\\":
                i += 1
            elif ch == '"':
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _quoted(text: str, lineno: int) -> Tuple[str, str]:
    """Parses the quoted scalar at the start of ``text``; returns (value,
    the rest of the text after the closing quote)."""
    quote, out, i = text[0], [], 1
    while i < len(text):
        ch = text[i]
        if quote == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if quote == '"' and ch == '"':
            return "".join(out), text[i + 1:]
        if quote == '"' and ch == "\\":
            esc = text[i + 1:i + 2]
            if esc not in _ESCAPES:
                raise _Error(lineno, f"unsupported escape in {text!r}")
            out.append(_ESCAPES[esc])
            i += 2
            continue
        out.append(ch)
        i += 1
    raise _Error(lineno, f"unterminated or multi-line quoted scalar {text!r}")


def _scalar(text: str, lineno: int) -> Any:
    text = text.strip()
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text, lineno)
        if rest.strip():
            raise _Error(lineno, f"text after a quoted scalar: {text!r}")
        return value
    if text[:1] in tuple("[]{}&*!|>%@`?") or text[:2] in ("- ", ": ") or text == "-":
        raise _Error(lineno, f"unsupported YAML construct {text!r}")
    if ": " in text or text.endswith(":"):
        raise _Error(lineno, f"a mapping is not allowed here: {text!r}")
    return _resolve_plain(text, lineno)


def _flow_list(text: str, lineno: int) -> List[Any]:
    """``[a, b, 'c']`` of scalars."""
    if not text.endswith("]"):
        raise _Error(lineno, f"multi-line or nested flow lists are not supported: {text!r}")
    body = text[1:-1].strip()
    items: List[Any] = []
    while body:
        if body[0] in ("'", '"'):
            value, body = _quoted(body, lineno)
            items.append(value)
        else:
            end = body.find(",")
            item = body if end < 0 else body[:end]
            if any(c in item for c in "[]{}"):
                raise _Error(lineno, f"nested flow collections are not supported: {text!r}")
            items.append(_scalar(item, lineno))
            body = "" if end < 0 else body[end:]
        body = body.strip()
        if body.startswith(","):
            body = body[1:].strip()
            if not body:
                break
        elif body:
            raise _Error(lineno, f"bad flow list {text!r}")
    return items


class _Reader:
    def __init__(self, text: str):
        self.lines: List[Tuple[int, int, str]] = []   # (line number, indent, content)
        for lineno, raw in enumerate(text.splitlines(), 1):
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise _Error(lineno, "tabs are not allowed in indentation")
            line = _strip_comment(raw)
            content = line.lstrip(" ")
            if not content or (not self.lines and content == "---"):
                continue
            if content.startswith(("---", "...", "%")) and len(line) == len(content):
                raise _Error(lineno, "multiple documents and directives are not supported")
            self.lines.append((lineno, len(line) - len(content), content))

    def parse(self) -> Dict[str, Any]:
        if not self.lines:
            return {}
        value, i = self._block(0, self.lines[0][1])
        if i < len(self.lines):
            raise _Error(self.lines[i][0], "unexpected indentation")
        if not isinstance(value, dict):
            raise _Error(self.lines[0][0], "the top level must be a mapping")
        return value

    def _is_item(self, i: int) -> bool:
        content = self.lines[i][2]
        return content == "-" or content.startswith("- ")

    def _block(self, i: int, indent: int):
        """The block collection whose first line is ``i`` at ``indent``."""
        return self._sequence(i, indent) if self._is_item(i) else self._mapping(i, indent)

    def _sequence(self, i: int, indent: int):
        items = []
        while i < len(self.lines) and self.lines[i][1] == indent and self._is_item(i):
            lineno, _, content = self.lines[i]
            text = content[1:].strip()
            if not text:
                raise _Error(lineno, "nested block collections in a sequence are not supported")
            items.append(self._inline(text, lineno))
            i += 1
        return items, i

    def _mapping(self, i: int, indent: int):
        out: Dict[Any, Any] = {}
        while i < len(self.lines) and self.lines[i][1] == indent:
            lineno, _, content = self.lines[i]
            if self._is_item(i):
                raise _Error(lineno, "a sequence item where a mapping key was expected")
            key, rest = self._split_key(content, lineno)
            i += 1
            tagged = rest == _TUPLE_TAG
            if rest and not tagged:
                out[key] = self._inline(rest, lineno)
                continue
            nested = i < len(self.lines) and (
                self.lines[i][1] > indent or (self.lines[i][1] == indent and self._is_item(i)))
            if nested:
                value, i = self._block(i, self.lines[i][1])
            else:
                value = [] if tagged else None
            if tagged:
                if not isinstance(value, list):
                    raise _Error(lineno, f"{_TUPLE_TAG} needs a sequence")
                value = tuple(value)
            out[key] = value
        if i < len(self.lines) and self.lines[i][1] > indent:
            raise _Error(self.lines[i][0], "unexpected indentation")
        return out, i

    @staticmethod
    def _split_key(content: str, lineno: int):
        if content[:1] in ("'", '"'):
            key, rest = _quoted(content, lineno)
            if not rest.startswith(":") or rest[1:2] not in ("", " "):
                raise _Error(lineno, f"expected 'key: value', got {content!r}")
            return key, rest[1:].strip()
        at = 0
        while True:
            at = content.find(":", at)
            if at < 0:
                raise _Error(lineno, f"expected 'key: value', got {content!r}")
            if at + 1 == len(content) or content[at + 1] == " ":
                break
            at += 1
        return _scalar(content[:at], lineno), content[at + 1:].strip()

    @staticmethod
    def _inline(text: str, lineno: int):
        """A value on the line: scalar, flow list, ``{}`` or a tagged flow list."""
        if text.startswith(_TUPLE_TAG + " "):
            rest = text[len(_TUPLE_TAG):].strip()
            if not rest.startswith("["):
                raise _Error(lineno, f"{_TUPLE_TAG} needs a sequence")
            return tuple(_flow_list(rest, lineno))
        if text.startswith("["):
            return _flow_list(text, lineno)
        if text == "{}":
            return {}
        return _scalar(text, lineno)


def parse_yaml(text: str) -> Dict[str, Any]:
    """The mapping PyYAML's SafeLoader (plus ``!!python/tuple``) gives
    ``text``, for the subset in the module docstring."""
    return _Reader(text).parse()


# ---------------------------------------------------------------- dump ----

def _dump_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:   # 1e-05 is a string in YAML 1.1
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str):
        if any(ord(c) < 32 or c == "\x7f" for c in value):
            raise ValueError(f"control characters are not supported: {value!r}")
        plain = (value and value == value.strip() and value[0] not in "-?:,[]{}#&*!|>'\"%@`"
                 and not any(c in value for c in ",[]{}") and ": " not in value
                 and " #" not in value and not value.endswith(":")
                 and _resolve_plain(value) == value)
        return value if plain else "'" + value.replace("'", "''") + "'"
    raise ValueError(f"cannot write a value of type {type(value).__name__}: {value!r}")


def _dump_mapping(data: Dict[Any, Any], indent: int, out: List[str]) -> None:
    pad = " " * indent
    for key, value in data.items():
        head = f"{pad}{_dump_scalar(key)}:"
        if isinstance(value, dict):
            if value:
                out.append(head)
                _dump_mapping(value, indent + 2, out)
            else:
                out.append(f"{head} {{}}")
        elif isinstance(value, (list, tuple)):
            if any(isinstance(v, (dict, list, tuple)) for v in value):
                raise ValueError(f"nested collections in {key!r} are not supported")
            out.append(f"{head} [{', '.join(_dump_scalar(v) for v in value)}]")
        else:
            out.append(f"{head} {_dump_scalar(value)}")


def dump_yaml(data: Dict[str, Any]) -> str:
    """YAML text that ``parse_yaml`` (and PyYAML) read back as ``data``,
    with tuples written as lists."""
    out: List[str] = []
    _dump_mapping(data, 0, out)
    return "\n".join(out) + "\n"


# -------------------------------------------------------------- Config ----

class Config:
    """Dotted-path access over a nested dict: cfg.get('Dataset.crop_size')."""

    def __init__(self, data: Dict[str, Any]):
        self.data = data

    def get(self, path: str, default: Any = None) -> Any:
        node: Any = self.data
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def require(self, path: str) -> Any:
        sentinel = object()
        val = self.get(path, sentinel)
        if val is sentinel:
            raise KeyError(f"missing config key: {path}")
        return val

    def set(self, path: str, value: Any) -> None:
        parts = path.split(".")
        node = self.data
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value


def load_config(path: str) -> Config:
    """Loads a reference-schema YAML."""
    with open(path, "r") as f:
        text = f.read()
    try:
        return Config(parse_yaml(text))
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def dump_config(cfg: Config, save_dir: str) -> str:
    """Writes the resolved config to ``save_dir/config.yaml``; returns its path."""
    os.makedirs(save_dir, exist_ok=True)
    out = os.path.join(save_dir, "config.yaml")
    with open(out, "w") as f:
        f.write(dump_yaml(cfg.data))
    return out
