"""A YAML reader for the configs without PyYAML (which the card's machine
lacks): `read_yaml(path)` gives what `yaml.safe_load` gives for the YAML it
reads, and raises a ValueError naming the construct and the line for the
rest.

It reads block mappings and sequences (nested by indentation, a sequence
also at its key's indentation, `- key: value` items), flow sequences and
mappings (`[a, b]`, `{a: 1}`, nested), plain scalars resolved as PyYAML's
YAML 1.1 resolvers do (null, bool with yes / no / on / off, int with 0b,
0x, leading-0 octal, `_` and base-60 `1:30`, float with a dot, .inf, .nan),
single- and double-quoted strings, and # comments. It refuses anchors and
aliases, tags, block scalars (| and >), documents markers and directives,
complex (?) and merge (<<) keys, plain scalars that run over several lines,
timestamps and tabs in the indentation.
"""
from __future__ import annotations

import json
import re
from typing import List, Tuple

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "true", "on"}
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")


def _fail(where: str, what: str):
    raise ValueError(f"{where}: cannot read {what} (this YAML reader takes block and flow "
                     "collections, plain and quoted scalars)")


def _sexagesimal(text: str, cast):
    value = 0
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return value


def _resolve_int(v: str) -> int:
    sign = -1 if v[0] == "-" else 1
    v = v.lstrip("+-").replace("_", "")
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if ":" in v:
        return sign * _sexagesimal(v, int)
    if v != "0" and v.startswith("0"):
        return sign * int(v, 8)
    return sign * int(v)


def _resolve_float(v: str) -> float:
    sign = -1.0 if v[0] == "-" else 1.0
    v = v.lstrip("+-").replace("_", "").lower()
    if v == ".inf":
        return sign * float("inf")
    if v == ".nan":
        return float("nan")
    if ":" in v:
        return sign * _sexagesimal(v, float)
    return sign * float(v)


def _plain(text: str, where: str):
    """A plain scalar as PyYAML's implicit resolvers type it."""
    if text[:1] in ("&", "*", "!", "|", ">", "%", "@", "`"):
        _fail(where, f"{text[:1]!r} ({text!r})")
    if text.startswith(("? ", "<<")) or text == "?":
        _fail(where, f"a complex or merge key ({text!r})")
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _INT.match(text):
        return _resolve_int(text)
    if _FLOAT.match(text):
        return _resolve_float(text)
    if _TIMESTAMP.match(text):
        _fail(where, f"a timestamp ({text!r})")
    return text


def _quoted(text: str, where: str) -> Tuple[str, int]:
    """The quoted scalar at the start of `text` and its length."""
    q = text[0]
    i = 1
    while True:
        j = text.find(q, i)
        if j < 0:
            _fail(where, "a quoted scalar that runs over several lines")
        if q == "'" and text[j + 1:j + 2] == "'":
            i = j + 2
            continue
        if q == '"':
            backslashes = len(text[:j]) - len(text[:j].rstrip("\\"))
            if backslashes % 2:
                i = j + 1
                continue
        break
    body = text[1:j]
    if q == "'":
        return body.replace("''", "'"), j + 1
    try:
        return json.loads('"' + body.replace("\\/", "/") + '"'), j + 1
    except ValueError:
        _fail(where, f"an escape of {text[:j + 1]!r}")


def _strip_comment(line: str) -> str:
    """The line without its comment: a # at the start or after a space,
    outside quotes."""
    q = None
    for i, ch in enumerate(line):
        if q:
            if ch == q:
                q = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            q = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _scalar(text: str, where: str):
    text = text.strip()
    if text[:1] in "'\"":
        value, n = _quoted(text, where)
        if text[n:].strip():
            _fail(where, f"text after a quoted scalar ({text!r})")
        return value
    return _plain(text, where)


def _flow(text: str, i: int, where: str):
    """The flow collection or scalar at text[i]: (value, next index)."""
    while text[i] == " ":
        i += 1
    if text[i] in "[{":
        close = "]" if text[i] == "[" else "}"
        items, pairs = [], {}
        i += 1
        while True:
            while text[i] == " ":
                i += 1
            if text[i] == close:
                return (items if close == "]" else pairs), i + 1
            key, i = _flow(text, i, where)
            while text[i] == " ":
                i += 1
            if close == "}":
                if text[i] != ":":
                    _fail(where, f"a flow mapping entry without ': ' ({text!r})")
                value, i = _flow(text, i + 1, where)
                pairs[key] = value
            else:
                items.append(key)
            while text[i] == " ":
                i += 1
            if text[i] == ",":
                i += 1
            elif text[i] != close:
                _fail(where, f"a flow collection ({text!r})")
    if text[i] in "'\"":
        value, n = _quoted(text[i:], where)
        return value, i + n
    j = i
    while j < len(text) and text[j] not in ",]}" and not (
            text[j] == ":" and text[j + 1:j + 2] in (" ", ",", "]", "}", "")):
        j += 1
    return _plain(text[i:j].strip(), where), j


def _value(text: str, where: str):
    text = text.strip()
    if text[:1] in "[{":
        try:
            value, n = _flow(text + " ", 0, where)
        except IndexError:
            _fail(where, f"an unclosed flow collection ({text!r})")
        if text[n:].strip():
            _fail(where, f"text after a flow collection ({text!r})")
        return value
    return _scalar(text, where)


def _split_key(text: str, where: str):
    """`key: rest` -> (key, rest), or None where `text` is no mapping entry."""
    if text[:1] in "'\"":
        key, n = _quoted(text, where)
        rest = text[n:].lstrip()
        return (key, rest[1:]) if rest.startswith(":") and rest[1:2] in ("", " ") else None
    m = re.match(r"^([^#\[\]{},]*?):(?: |$)", text)
    if not m or text[:1] in "[{":
        return None
    return _plain(m.group(1).strip(), where), text[m.end():]


class _Reader:
    def __init__(self, lines: List[Tuple[int, str, str]]):
        self.lines = lines  # (indent, text, where)
        self.i = 0

    def block(self, indent: int):
        first_indent, text, where = self.lines[self.i]
        if text == "-" or text.startswith("- "):
            return self.sequence(first_indent)
        if _split_key(text, where) is not None:
            return self.mapping(first_indent)
        self.i += 1
        if self.i < len(self.lines) and self.lines[self.i][0] > indent:
            _fail(self.lines[self.i][2], "a plain scalar that runs over several lines")
        return _value(text, where)

    def nested(self, parent_indent: int, same_level_seq: bool):
        """The node under a `key:` or `-` with nothing after it."""
        if self.i >= len(self.lines):
            return None
        indent, text, _ = self.lines[self.i]
        if indent > parent_indent or (same_level_seq and indent == parent_indent
                                      and (text == "-" or text.startswith("- "))):
            return self.block(indent)
        return None

    def mapping(self, indent: int):
        out = {}
        while self.i < len(self.lines):
            ind, text, where = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                _fail(where, "an indentation this reader cannot place")
            kv = _split_key(text, where)
            if kv is None:
                if text == "-" or text.startswith("- "):
                    break
                _fail(where, f"a line that is no mapping entry ({text!r})")
            key, rest = kv
            self.i += 1
            out[key] = self.nested(indent, True) if not rest.strip() else self.inline(
                rest, indent, where)
        return out

    def inline(self, rest: str, indent: int, where: str):
        value = _value(rest, where)
        if self.i < len(self.lines) and self.lines[self.i][0] > indent:
            _fail(self.lines[self.i][2], "a plain scalar that runs over several lines")
        return value

    def sequence(self, indent: int):
        out = []
        while self.i < len(self.lines):
            ind, text, where = self.lines[self.i]
            if ind != indent or not (text == "-" or text.startswith("- ")):
                if ind > indent:
                    _fail(where, "an indentation this reader cannot place")
                break
            rest = text[1:].lstrip()
            if not rest:
                self.i += 1
                out.append(self.nested(indent, False))
            elif rest == "-" or rest.startswith("- ") or _split_key(rest, where) is not None:
                # a compact nested node: it starts where `rest` does
                self.lines[self.i] = (ind + len(text) - len(rest), rest, where)
                out.append(self.block(ind + len(text) - len(rest)))
            else:
                self.i += 1
                out.append(self.inline(rest, indent, where))
        return out


def loads(text: str, name: str = "<yaml>"):
    """The document in `text`, as yaml.safe_load gives it."""
    lines = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{lineno}"
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            _fail(where, "a tab in the indentation")
        body = _strip_comment(body)
        if not body:
            continue
        if raw.startswith(("---", "...", "%")):
            _fail(where, f"a document marker or directive ({raw.strip()!r})")
        lines.append((len(raw) - len(raw.lstrip(" ")), body, where))
    if not lines:
        return None
    reader = _Reader(lines)
    value = reader.block(lines[0][0])
    if reader.i < len(lines):
        _fail(lines[reader.i][2], f"a line after the document's end ({lines[reader.i][1]!r})")
    return value


def read_yaml(path: str):
    """The YAML file at `path`, as yaml.safe_load(open(path)) gives it."""
    with open(path) as f:
        return loads(f.read(), path)
