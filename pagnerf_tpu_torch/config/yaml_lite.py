"""A reader and a writer for the YAML subset of the repository's configs.

The card's machine has no PyYAML, so the port carries its own. The subset is
what ``configs/`` and the datasets' files use (``params.yaml``,
``BUP_20.yaml``, as PyYAML's ``safe_dump`` writes them): block mappings
nested by indentation, block sequences (``- x``, nested ``- - x``,
sequences of mappings, a sequence at its key's indentation), ``#``
comments, plain or quoted scalars, and flow lists such as ``[96, 72]`` or
``[[1, 2], []]``. Plain scalars resolve as PyYAML's ``safe_load`` resolves
them (YAML 1.1): ``true`` / ``yes`` / ``on`` and their negations are
booleans, ``~`` / ``null`` / an empty value are None, integers may be hex,
octal or binary, and a float needs a dot (``1e-4`` stays a string, as it
does in PyYAML). Anything outside the subset -- anchors, tags, multi-line
scalars, flow mappings, tabs, documents -- raises ``YamlLiteError``.

``dump`` writes nested dicts of scalars and lists in the same subset, block
mappings with sorted keys and lists as flow lists, so ``load(dump(x)) == x``
and PyYAML reads the same values.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Tuple

_BOOL_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_BOOL_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_NULL = {"~", "null", "Null", "NULL", ""}
# PyYAML's implicit resolvers (resolver.py), YAML 1.1
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                      |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                      |[-+]?\.(?:inf|Inf|INF)
                      |\.(?:nan|NaN|NAN))$""", re.X)
# forms PyYAML resolves that the subset leaves out: sexagesimal numbers
# (``1:30``), timestamps, the merge key and the value key
_UNSUPPORTED = re.compile(r"""^(?:[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?
                            |[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*
                            |<<|=)$""", re.X)
_INDICATORS = set("&*!|>%@`{}")


class YamlLiteError(ValueError):
    """The text is not in the supported YAML subset."""


def resolve_plain(text: str) -> Any:
    """A plain scalar's value, as PyYAML's resolvers give it."""
    if text in _NULL:
        return None
    if text in _BOOL_TRUE:
        return True
    if text in _BOOL_FALSE:
        return False
    if _UNSUPPORTED.match(text):
        raise YamlLiteError(f"scalar {text!r} is outside the supported YAML subset")
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v != "0" and v.startswith("0"):
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        if v.endswith(".inf"):
            return -math.inf if v[0] == "-" else math.inf
        if v.endswith(".nan"):
            return math.nan
        return float(v)
    return text


def _strip_comment(line: str) -> str:
    """``line`` without a trailing comment (a ``#`` at the start or after a
    space, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _quoted(text: str, lineno: int) -> Tuple[str, str]:
    """(value, rest) of a quoted scalar at the start of ``text``."""
    q = text[0]
    out, i = [], 1
    while i < len(text):
        ch = text[i]
        if q == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if q == '"' and ch == "\\":
            esc = text[i + 1:i + 2]
            repl = {'"': '"', "\\": "\\", "n": "\n", "t": "\t", "/": "/"}.get(esc)
            if repl is None:
                raise YamlLiteError(f"line {lineno}: escape \\{esc} is outside the subset")
            out.append(repl)
            i += 2
            continue
        if q == '"' and ch == '"':
            return "".join(out), text[i + 1:]
        out.append(ch)
        i += 1
    raise YamlLiteError(f"line {lineno}: unterminated quoted scalar")


def _scalar(text: str, lineno: int, in_flow: bool = False) -> Any:
    text = text.strip()
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text, lineno)
        if rest.strip():
            raise YamlLiteError(f"line {lineno}: text after a quoted scalar: {rest!r}")
        return value
    if text[:1] in _INDICATORS or text.startswith(("- ", "? ")) or text in ("-", "?"):
        raise YamlLiteError(f"line {lineno}: {text!r} is outside the supported YAML subset")
    if ": " in text or text.endswith(":") or (in_flow and any(c in text for c in "[]{},")):
        raise YamlLiteError(f"line {lineno}: {text!r} is not a plain scalar")
    return resolve_plain(text)


def _flow_items(text: str, pos: int, lineno: int) -> Tuple[List[Any], int]:
    """(items, position after the closing bracket) of the flow list whose
    ``[`` is at ``text[pos]``; nested lists recurse."""
    items: List[Any] = []
    cur: List[str] = []
    pending = False            # a value since the last comma
    i = pos + 1
    while i < len(text):
        ch = text[i]
        if ch in "'\"" and not "".join(cur).strip():
            value, rest = _quoted(text[i:], lineno)
            cur = [text[i:len(text) - len(rest)]]
            i = len(text) - len(rest)
            continue
        if ch == "[" and not "".join(cur).strip():
            value, i = _flow_items(text, i, lineno)
            items.append(value)
            pending = True
            continue
        if ch in ",]":
            if "".join(cur).strip():
                if pending:
                    raise YamlLiteError(f"line {lineno}: text after a nested flow list")
                items.append(_scalar("".join(cur), lineno, in_flow=True))
            elif ch == "," and not pending:
                raise YamlLiteError(f"line {lineno}: an empty entry in a flow list")
            cur, pending = [], False
            i += 1
            if ch == "]":
                return items, i
            continue
        if ch in "[]{}":
            raise YamlLiteError(f"line {lineno}: flow mappings are outside the subset")
        cur.append(ch)
        i += 1
    raise YamlLiteError(f"line {lineno}: a flow list must close on its line")


def _flow_list(text: str, lineno: int) -> List[Any]:
    text = text.strip()
    items, end = _flow_items(text, 0, lineno)
    if text[end:].strip():
        raise YamlLiteError(f"line {lineno}: text after a flow list: {text[end:]!r}")
    return items


def _value(text: str, lineno: int) -> Any:
    text = text.strip()
    if text.startswith("["):
        return _flow_list(text, lineno)
    return _scalar(text, lineno)


def _split_key(body: str, lineno: int) -> Tuple[Any, str]:
    """(key, rest after ``: ``) of a mapping entry."""
    if body[:1] in ("'", '"'):
        key, rest = _quoted(body, lineno)
        rest = rest.lstrip(" ")
        if not rest.startswith(":"):
            raise YamlLiteError(f"line {lineno}: expected ':' after a quoted key")
        return key, rest[1:]
    m = re.match(r"^([^:]*?):(?:\s+|$)(.*)$", body)
    if not m or not m.group(1).strip():
        raise YamlLiteError(f"line {lineno}: {body!r} is not a 'key: value' entry")
    return _scalar(m.group(1), lineno), m.group(2)


def load(text: str) -> Any:
    """The value of a YAML document in the subset: a dict or a list, or None
    for an empty document."""
    lines: List[Tuple[int, int, str]] = []     # (lineno, indent, body)
    for lineno, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YamlLiteError(f"line {lineno}: tabs are outside the subset")
        body = _strip_comment(raw).rstrip()
        if not body.strip():
            continue
        if body.startswith(("---", "...", "%")):
            raise YamlLiteError(f"line {lineno}: document markers are outside the subset")
        indent = len(body) - len(body.lstrip(" "))
        lines.append((lineno, indent, body.strip()))
    if not lines:
        return None
    value, pos = _node(lines, 0, lines[0][1])
    if pos != len(lines):
        lineno = lines[pos][0]
        raise YamlLiteError(f"line {lineno}: unexpected indentation")
    return value


def _is_item(body: str) -> bool:
    return body == "-" or body.startswith("- ")


def _is_entry(body: str) -> bool:
    """Whether ``body`` starts a mapping entry (``key:`` or ``key: value``)."""
    if body[:1] in ("'", '"'):
        try:
            _, rest = _quoted(body, 0)
        except YamlLiteError:
            return False
        return rest.lstrip(" ").startswith(":")
    if body[:1] in "[{":
        return False
    return re.match(r"^[^:]*?:(?:\s|$)", body) is not None


def _node(lines, pos: int, indent: int) -> Tuple[Any, int]:
    """The block sequence or mapping whose entries start at column
    ``indent`` from ``pos``."""
    if _is_item(lines[pos][2]):
        return _sequence(lines, pos, indent)
    return _block(lines, pos, indent)


def _inline(lines, pos: int, indent: int, lineno: int, col: int, body: str
            ) -> Tuple[Any, int]:
    """The value that starts on a line after an item's ``- `` (at column
    ``col``): a nested sequence or a mapping continued on the lines at
    ``col``, else one value on its own line."""
    if _is_item(body) or _is_entry(body):
        lines[pos] = (lineno, col, body)
        return _node(lines, pos, col)
    value = _value(body, lineno)
    pos += 1
    if pos < len(lines) and lines[pos][1] > indent:
        raise YamlLiteError(f"line {lines[pos][0]}: multi-line scalars are outside the subset")
    return value, pos


def _sequence(lines, pos: int, indent: int) -> Tuple[List[Any], int]:
    """The block sequence whose ``- `` items start at column ``indent``."""
    out: List[Any] = []
    while pos < len(lines):
        lineno, ind, body = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            raise YamlLiteError(f"line {lineno}: unexpected indentation")
        if not _is_item(body):
            break
        rest = body[1:].lstrip(" ")
        if not rest:
            pos += 1
            if pos < len(lines) and lines[pos][1] > indent:
                value, pos = _node(lines, pos, lines[pos][1])
            else:
                value = None
        else:
            value, pos = _inline(lines, pos, indent, lineno, ind + len(body) - len(rest), rest)
        out.append(value)
    return out, pos


def _block(lines, pos: int, indent: int) -> Tuple[Dict, int]:
    """The mapping whose entries start at column ``indent`` from ``pos``."""
    out: Dict[Any, Any] = {}
    while pos < len(lines):
        lineno, ind, body = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            raise YamlLiteError(f"line {lineno}: unexpected indentation")
        if _is_item(body):
            if out:
                break                  # the parent sequence's next item
            raise YamlLiteError(f"line {lineno}: a sequence item inside a mapping")
        key, rest = _split_key(body, lineno)
        pos += 1
        if rest.strip():
            out[key] = _value(rest, lineno)
            if pos < len(lines) and lines[pos][1] > indent:
                raise YamlLiteError(
                    f"line {lines[pos][0]}: multi-line scalars are outside the subset")
        elif pos < len(lines) and lines[pos][1] > indent:
            out[key], pos = _node(lines, pos, lines[pos][1])
        elif pos < len(lines) and lines[pos][1] == indent and _is_item(lines[pos][2]):
            # a sequence may sit at its key's indentation
            out[key], pos = _sequence(lines, pos, indent)
        else:
            out[key] = None
    return out, pos


# ------------------------------------------------------------------ writer
def _dump_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        s = repr(v).lower()
        if "." not in s and "e" in s:       # PyYAML's float form: 1.0e-05
            s = s.replace("e", ".0e")
        return s
    if isinstance(v, str):
        plain = (v == v.strip() and v and not any(c in v for c in "#,[]{}'\"\n")
                 and ": " not in v and not v.endswith(":")
                 and v[0] not in _INDICATORS and v[0] not in "-?"
                 and not _UNSUPPORTED.match(v))
        if plain and resolve_plain(v) == v:
            return v
        return "'" + v.replace("'", "''") + "'"
    raise YamlLiteError(f"cannot write a {type(v).__name__} value in the subset")


def _dump_flow(v: Any) -> str:
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_dump_flow(x) for x in v) + "]"
    if isinstance(v, dict):
        raise YamlLiteError("a mapping in a list is outside the writer's subset")
    return _dump_scalar(v)


def dump(data: Dict, indent: int = 0) -> str:
    """``data`` (nested dicts of scalars and lists) as block YAML with
    sorted keys; lists, nested ones too, as flow lists."""
    out = []
    pad = " " * indent
    for key in sorted(data, key=str):
        v = data[key]
        k = _dump_scalar(key)
        if isinstance(v, dict):
            if v:
                out.append(f"{pad}{k}:\n" + dump(v, indent + 2))
            else:
                raise YamlLiteError("an empty mapping is outside the subset")
        elif isinstance(v, (list, tuple)):
            out.append(f"{pad}{k}: {_dump_flow(v)}\n")
        else:
            out.append(f"{pad}{k}: {_dump_scalar(v)}\n")
    return "".join(out)
