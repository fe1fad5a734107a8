"""A YAML reader for the configs without PyYAML (which the card's machine
lacks): `read_yaml(path)` gives what `yaml.safe_load` gives for a
single-document stream, and raises a ValueError naming the line where
SafeLoader raises.

It follows PyYAML's SafeLoader stage by stage, so that what it accepts and
what it builds are PyYAML's: a scanner of YAML 1.1 tokens (simple and
complex `?` keys, block and flow collections, plain scalars over several
lines, single- and double-quoted scalars with every escape, literal `|` and
folded `>` block scalars with their chomping and indentation indicators,
anchors, aliases, tags, `%YAML` / `%TAG` directives, `---` / `...`), a
recursive parser that composes the node graph (an alias is the anchored
node itself), the implicit resolvers (null, bool with yes / no / on / off,
int with 0b, 0x, leading-0 octal, `_` and base-60, float, `<<` merge keys,
timestamps) and the safe constructors (str, int, float, bool, null, binary,
timestamp as datetime.date / datetime.datetime, seq, map with merges, set,
omap and pairs; an aliased node gives the same object). A second document,
an unknown or local tag, an unhashable key, tabs that start a token and any
other stream SafeLoader refuses raise.
"""
from __future__ import annotations

import base64
import binascii
import datetime
import re
from typing import Dict, List, Optional

_BREAKS = "\r\n\x85\u2028\u2029"
_BLANK_END = "\0 \t" + _BREAKS  # what may follow an indicator
_TAG = "tag:yaml.org,2002:"
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\x09", "\t": "\x09", "n": "\x0a",
            "v": "\x0b", "f": "\x0c", "r": "\x0d", "e": "\x1b", " ": " ", '"': '"',
            "\\": "\\", "/": "/", "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
_HEX = "0123456789ABCDEFabcdef"
_WORD = re.compile(r"[0-9A-Za-z_-]*")
_URI = re.compile(r"[0-9A-Za-z\-;/?:@&=+$,_.!~*'()\[\]%]*")
_NON_PRINTABLE = re.compile("[^\x09\x0a\x0d\x20-\x7e\x85\xa0-\ud7ff\ue000-\ufffd"
                            "\U00010000-\U0010ffff]")

# PyYAML's implicit resolvers, by first character, in its order
_RESOLVERS = [
    ("bool", re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                        r"|on|On|ON|off|Off|OFF)$"), "yYnNtTfFoO"),
    ("float", re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                         r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$"), "-+0123456789."),
    ("int", re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                       r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$"),
     "-+0123456789"),
    ("merge", re.compile(r"^(?:<<)$"), "<"),
    ("null", re.compile(r"^(?:~|null|Null|NULL|)$"), "~nN"),
    ("timestamp", re.compile(r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
                             r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
                             r"(?:[Tt]|[ \t]+)[0-9][0-9]?"
                             r":[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
                             r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$"),
     "0123456789"),
    ("value", re.compile(r"^(?:=)$"), "="),
]
_TIMESTAMP = re.compile(
    r"^(?P<year>[0-9][0-9][0-9][0-9])-(?P<month>[0-9][0-9]?)-(?P<day>[0-9][0-9]?)"
    r"(?:(?:[Tt]|[ \t]+)(?P<hour>[0-9][0-9]?):(?P<minute>[0-9][0-9]):(?P<second>[0-9][0-9])"
    r"(?:\.(?P<fraction>[0-9]*))?"
    r"(?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)"
    r"(?::(?P<tz_minute>[0-9][0-9]))?))?)?$")


class _Error(ValueError):
    pass


class _Tok:
    __slots__ = ("id", "value", "plain", "line")

    def __init__(self, id, line, value=None, plain=False):
        self.id, self.line, self.value, self.plain = id, line, value, plain


class _SimpleKey:
    __slots__ = ("token_number", "required", "index", "line", "column")

    def __init__(self, token_number, required, index, line, column):
        self.token_number, self.required = token_number, required
        self.index, self.line, self.column = index, line, column


class _Node:
    __slots__ = ("kind", "tag", "value", "line")

    def __init__(self, kind, tag, value, line):
        self.kind, self.tag, self.value, self.line = kind, tag, value, line


class _Scanner:
    """PyYAML's scanner: characters to tokens, with its simple-key and
    indentation bookkeeping."""

    def __init__(self, text: str, name: str):
        m = _NON_PRINTABLE.search(text)
        self.name = name
        self.buf = text + "\0"
        self.index = self.line = self.column = 0
        if m:
            self.line = text.count("\n", 0, m.start())
            self.fail(f"a special character #x{ord(m.group()):04x}: special characters "
                      "are not allowed")
        self.done = False
        self.flow_level = 0
        self.tokens: List[_Tok] = []
        self.tokens_taken = 0
        self.indent = -1
        self.indents: List[int] = []
        self.allow_simple_key = True
        self.possible: Dict[int, _SimpleKey] = {}
        self.tokens.append(_Tok("stream-start", 0))

    def fail(self, what: str, line: Optional[int] = None):
        raise _Error(f"{self.name}, line {(self.line if line is None else line) + 1}: "
                     f"cannot read {what}")

    # characters
    def peek(self, i: int = 0) -> str:
        j = self.index + i
        return self.buf[j] if j < len(self.buf) else "\0"

    def prefix(self, n: int = 1) -> str:
        return self.buf[self.index:self.index + n]

    def forward(self, n: int = 1) -> None:
        for _ in range(n):
            ch = self.buf[self.index]
            self.index += 1
            if ch in "\n\x85\u2028\u2029" or (ch == "\r" and self.buf[self.index] != "\n"):
                self.line += 1
                self.column = 0
            elif ch != "\ufeff":
                self.column += 1

    # the token queue
    def check(self, *ids) -> bool:
        while self.need_more():
            self.fetch_more()
        return bool(self.tokens) and (not ids or self.tokens[0].id in ids)

    def peek_token(self) -> _Tok:
        while self.need_more():
            self.fetch_more()
        return self.tokens[0]

    def get_token(self) -> _Tok:
        self.peek_token()
        self.tokens_taken += 1
        return self.tokens.pop(0)

    def need_more(self) -> bool:
        if self.done:
            return False
        if not self.tokens:
            return True
        self.stale_simple_keys()
        return self.next_simple_key() == self.tokens_taken

    def fetch_more(self) -> None:
        self.scan_to_next_token()
        self.stale_simple_keys()
        self.unwind_indent(self.column)
        ch = self.peek()
        if ch == "\0":
            self.unwind_indent(-1)
            self.remove_simple_key()
            self.allow_simple_key = False
            self.possible = {}
            self.tokens.append(_Tok("stream-end", self.line))
            self.done = True
        elif ch == "%" and self.column == 0:
            self.unwind_indent(-1)
            self.remove_simple_key()
            self.allow_simple_key = False
            self.tokens.append(self.scan_directive())
        elif ch in "-." and self.column == 0 and self.prefix(3) in ("---", "...") \
                and self.peek(3) in _BLANK_END:
            self.unwind_indent(-1)
            self.remove_simple_key()
            self.allow_simple_key = False
            line = self.line
            self.forward(3)
            self.tokens.append(_Tok("document-start" if ch == "-" else "document-end", line))
        elif ch in "[{":
            self.save_simple_key()
            self.flow_level += 1
            self.allow_simple_key = True
            self.add_simple(("flow-sequence-start" if ch == "[" else "flow-mapping-start"))
        elif ch in "]}":
            self.remove_simple_key()
            self.flow_level -= 1
            self.allow_simple_key = False
            self.add_simple(("flow-sequence-end" if ch == "]" else "flow-mapping-end"))
        elif ch == ",":
            self.allow_simple_key = True
            self.remove_simple_key()
            self.add_simple("flow-entry")
        elif ch == "-" and self.peek(1) in _BLANK_END:
            if not self.flow_level:
                if not self.allow_simple_key:
                    self.fail("a sequence entry here: sequence entries are not allowed here")
                if self.add_indent(self.column):
                    self.tokens.append(_Tok("block-sequence-start", self.line))
            self.allow_simple_key = True
            self.remove_simple_key()
            self.add_simple("block-entry")
        elif ch == "?" and (self.flow_level or self.peek(1) in _BLANK_END):
            if not self.flow_level:
                if not self.allow_simple_key:
                    self.fail("a complex key here: mapping keys are not allowed here")
                if self.add_indent(self.column):
                    self.tokens.append(_Tok("block-mapping-start", self.line))
            self.allow_simple_key = not self.flow_level
            self.remove_simple_key()
            self.add_simple("key")
        elif ch == ":" and (self.flow_level or self.peek(1) in _BLANK_END):
            self.fetch_value()
        elif ch in "*&":
            self.save_simple_key()
            self.allow_simple_key = False
            self.tokens.append(self.scan_anchor())
        elif ch == "!":
            self.save_simple_key()
            self.allow_simple_key = False
            self.tokens.append(self.scan_tag())
        elif ch in "|>" and not self.flow_level:
            self.allow_simple_key = True
            self.remove_simple_key()
            self.tokens.append(self.scan_block_scalar(ch))
        elif ch in "'\"":
            self.save_simple_key()
            self.allow_simple_key = False
            self.tokens.append(self.scan_flow_scalar(ch))
        elif (ch not in "\0 \t\r\n\x85\u2028\u2029-?:,[]{}#&*!|>'\"%@`"
              or (self.peek(1) not in _BLANK_END
                  and (ch == "-" or (not self.flow_level and ch in "?:")))):
            self.save_simple_key()
            self.allow_simple_key = False
            self.tokens.append(self.scan_plain())
        else:
            what = "a tab" if ch == "\t" else repr(ch)
            self.fail(f"{what}: found character {ch!r} that cannot start any token")

    def add_simple(self, id: str) -> None:
        line = self.line
        self.forward()
        self.tokens.append(_Tok(id, line))

    def fetch_value(self) -> None:
        key = self.possible.pop(self.flow_level, None)
        if key is not None:
            at = key.token_number - self.tokens_taken
            self.tokens.insert(at, _Tok("key", key.line))
            if not self.flow_level and self.add_indent(key.column):
                self.tokens.insert(at, _Tok("block-mapping-start", key.line))
            self.allow_simple_key = False
        else:
            if not self.flow_level:
                if not self.allow_simple_key:
                    self.fail("a mapping value here: mapping values are not allowed here")
                if self.add_indent(self.column):
                    self.tokens.append(_Tok("block-mapping-start", self.line))
            self.allow_simple_key = not self.flow_level
            self.remove_simple_key()
        self.add_simple("value")

    # simple keys and indentation
    def next_simple_key(self):
        numbers = [k.token_number for k in self.possible.values()]
        return min(numbers) if numbers else None

    def stale_simple_keys(self) -> None:
        for level in list(self.possible):
            key = self.possible[level]
            if key.line != self.line or self.index - key.index > 1024:
                if key.required:
                    self.fail("a simple key: could not find expected ':'", key.line)
                del self.possible[level]

    def save_simple_key(self) -> None:
        required = not self.flow_level and self.indent == self.column
        if self.allow_simple_key:
            self.remove_simple_key()
            self.possible[self.flow_level] = _SimpleKey(
                self.tokens_taken + len(self.tokens), required, self.index, self.line,
                self.column)

    def remove_simple_key(self) -> None:
        key = self.possible.pop(self.flow_level, None)
        if key is not None and key.required:
            self.fail("a simple key: could not find expected ':'", key.line)

    def unwind_indent(self, column: int) -> None:
        if self.flow_level:
            return
        while self.indent > column:
            self.indent = self.indents.pop()
            self.tokens.append(_Tok("block-end", self.line))

    def add_indent(self, column: int) -> bool:
        if self.indent < column:
            self.indents.append(self.indent)
            self.indent = column
            return True
        return False

    # scanners
    def scan_to_next_token(self) -> None:
        if self.index == 0 and self.peek() == "\ufeff":
            self.forward()
        while True:
            while self.peek() == " ":
                self.forward()
            if self.peek() == "#":
                while self.peek() not in "\0" + _BREAKS:
                    self.forward()
            if self.scan_line_break():
                if not self.flow_level:
                    self.allow_simple_key = True
            else:
                return

    def scan_line_break(self) -> str:
        ch = self.peek()
        if ch in "\r\n\x85":
            self.forward(2 if self.prefix(2) == "\r\n" else 1)
            return "\n"
        if ch in "\u2028\u2029":
            self.forward()
            return ch
        return ""

    def scan_word(self, what: str) -> str:
        n = _WORD.match(self.buf, self.index).end() - self.index
        if not n:
            self.fail(f"{what}: expected alphabetic or numeric character, but found "
                      f"{self.peek()!r}")
        value = self.prefix(n)
        self.forward(n)
        return value

    def skip_to_line_end(self, what: str) -> None:
        while self.peek() == " ":
            self.forward()
        if self.peek() == "#":
            while self.peek() not in "\0" + _BREAKS:
                self.forward()
        if self.peek() not in "\0" + _BREAKS:
            self.fail(f"{what}: expected a comment or a line break, but found "
                      f"{self.peek()!r}")
        self.scan_line_break()

    def scan_directive(self) -> _Tok:
        line = self.line
        self.forward()
        name = self.scan_word("a directive")
        if self.peek() not in "\0 " + _BREAKS:
            self.fail(f"a directive: expected alphabetic or numeric character, but found "
                      f"{self.peek()!r}")
        value = None
        if name == "YAML":
            while self.peek() == " ":
                self.forward()
            major = self.scan_version_number()
            if self.peek() != ".":
                self.fail(f"a directive: expected a digit or '.', but found {self.peek()!r}")
            self.forward()
            minor = self.scan_version_number()
            if self.peek() not in "\0 " + _BREAKS:
                self.fail(f"a directive: expected a digit or ' ', but found {self.peek()!r}")
            value = (major, minor)
        elif name == "TAG":
            while self.peek() == " ":
                self.forward()
            handle = self.scan_tag_handle("directive")
            if self.peek() != " ":
                self.fail(f"a directive: expected ' ', but found {self.peek()!r}")
            while self.peek() == " ":
                self.forward()
            prefix = self.scan_tag_uri("directive")
            if self.peek() not in "\0 " + _BREAKS:
                self.fail(f"a directive: expected ' ', but found {self.peek()!r}")
            value = (handle, prefix)
        else:
            while self.peek() not in "\0" + _BREAKS:
                self.forward()
        self.skip_to_line_end("a directive")
        return _Tok("directive", line, value=(name, value))

    def scan_version_number(self) -> int:
        n = 0
        while "0" <= self.peek(n) <= "9":
            n += 1
        if not n:
            self.fail(f"a directive: expected a digit, but found {self.peek()!r}")
        value = int(self.prefix(n))
        self.forward(n)
        return value

    def scan_anchor(self) -> _Tok:
        line = self.line
        kind = "alias" if self.peek() == "*" else "anchor"
        self.forward()
        name = self.scan_word(f"an {kind}")
        if self.peek() not in "\0 \t" + _BREAKS + "?:,]}%@`":
            self.fail(f"an {kind}: expected alphabetic or numeric character, but found "
                      f"{self.peek()!r}")
        return _Tok(kind, line, value=name)

    def scan_tag(self) -> _Tok:
        line = self.line
        ch = self.peek(1)
        if ch == "<":
            handle = None
            self.forward(2)
            suffix = self.scan_tag_uri("tag")
            if self.peek() != ">":
                self.fail(f"a tag: expected '>', but found {self.peek()!r}")
            self.forward()
        elif ch in _BLANK_END:
            handle, suffix = None, "!"
            self.forward()
        else:
            n, use_handle = 1, False
            while ch not in "\0 " + _BREAKS:
                if ch == "!":
                    use_handle = True
                    break
                n += 1
                ch = self.peek(n)
            if use_handle:
                handle = self.scan_tag_handle("tag")
            else:
                handle = "!"
                self.forward()
            suffix = self.scan_tag_uri("tag")
        if self.peek() not in "\0 " + _BREAKS:
            self.fail(f"a tag: expected ' ', but found {self.peek()!r}")
        return _Tok("tag", line, value=(handle, suffix))

    def scan_tag_handle(self, what: str) -> str:
        if self.peek() != "!":
            self.fail(f"a {what}: expected '!', but found {self.peek()!r}")
        n = 1
        if self.peek(1) != " ":
            n = _WORD.match(self.buf, self.index + 1).end() - self.index
            if self.peek(n) != "!":
                self.forward(n)
                self.fail(f"a {what}: expected '!', but found {self.peek()!r}")
            n += 1
        value = self.prefix(n)
        self.forward(n)
        return value

    def scan_tag_uri(self, what: str) -> str:
        chunks = []
        while True:
            n = _URI.match(self.buf, self.index).end() - self.index
            pct = self.prefix(n).find("%")
            if pct < 0:
                break
            chunks.append(self.prefix(pct))
            self.forward(pct)
            codes = []
            while self.peek() == "%":
                self.forward()
                if self.peek(0) not in _HEX or self.peek(1) not in _HEX:
                    self.fail(f"a {what}: expected URI escape sequence of 2 hexadecimal "
                              "numbers")
                codes.append(int(self.prefix(2), 16))
                self.forward(2)
            try:
                chunks.append(bytes(codes).decode("utf-8"))
            except UnicodeDecodeError as exc:
                self.fail(f"a {what}: {exc}")
        if n:
            chunks.append(self.prefix(n))
            self.forward(n)
        if not chunks:
            self.fail(f"a {what}: expected URI, but found {self.peek()!r}")
        return "".join(chunks)

    def scan_block_scalar(self, style: str) -> _Tok:
        folded = style == ">"
        line = self.line
        self.forward()
        chomping = increment = None
        ch = self.peek()
        for _ in range(2):
            if ch in "+-" and chomping is None:
                chomping = ch == "+"
            elif ch in "0123456789" and increment is None:
                increment = int(ch)
                if increment == 0:
                    self.fail("a block scalar: expected indentation indicator in the range "
                              "1-9, but found 0")
            else:
                break
            self.forward()
            ch = self.peek()
        if self.peek() not in "\0 " + _BREAKS:
            self.fail(f"a block scalar: expected chomping or indentation indicators, but "
                      f"found {self.peek()!r}")
        self.skip_to_line_end("a block scalar")
        min_indent = max(self.indent + 1, 1)
        if increment is None:
            breaks, max_indent = [], 0
            while self.peek() in " " + _BREAKS:
                if self.peek() != " ":
                    breaks.append(self.scan_line_break())
                else:
                    self.forward()
                    max_indent = max(max_indent, self.column)
            indent = max(min_indent, max_indent)
        else:
            indent = min_indent + increment - 1
            breaks = self.scan_block_breaks(indent)
        chunks, line_break = [], ""
        while self.column == indent and self.peek() != "\0":
            chunks.extend(breaks)
            leading_non_space = self.peek() not in " \t"
            n = 0
            while self.peek(n) not in "\0" + _BREAKS:
                n += 1
            chunks.append(self.prefix(n))
            self.forward(n)
            line_break = self.scan_line_break()
            breaks = self.scan_block_breaks(indent)
            if self.column == indent and self.peek() != "\0":
                if (folded and line_break == "\n" and leading_non_space
                        and self.peek() not in " \t"):
                    if not breaks:
                        chunks.append(" ")
                else:
                    chunks.append(line_break)
            else:
                break
        if chomping is not False:
            chunks.append(line_break)
        if chomping is True:
            chunks.extend(breaks)
        return _Tok("scalar", line, "".join(chunks))

    def scan_block_breaks(self, indent: int) -> List[str]:
        chunks = []
        while self.column < indent and self.peek() == " ":
            self.forward()
        while self.peek() in _BREAKS:
            chunks.append(self.scan_line_break())
            while self.column < indent and self.peek() == " ":
                self.forward()
        return chunks

    def scan_flow_scalar(self, quote: str) -> _Tok:
        double = quote == '"'
        line = self.line
        self.forward()
        chunks = self.scan_non_spaces(double, line)
        while self.peek() != quote:
            chunks.extend(self.scan_flow_spaces(double, line))
            chunks.extend(self.scan_non_spaces(double, line))
        self.forward()
        return _Tok("scalar", line, "".join(chunks))

    def scan_non_spaces(self, double: bool, line: int) -> List[str]:
        chunks = []
        while True:
            n = 0
            while self.peek(n) not in "'\"\\\0 \t" + _BREAKS:
                n += 1
            if n:
                chunks.append(self.prefix(n))
                self.forward(n)
            ch = self.peek()
            if not double and ch == "'" and self.peek(1) == "'":
                chunks.append("'")
                self.forward(2)
            elif (double and ch == "'") or (not double and ch in '"\\'):
                chunks.append(ch)
                self.forward()
            elif double and ch == "\\":
                self.forward()
                ch = self.peek()
                if ch in _ESCAPES:
                    chunks.append(_ESCAPES[ch])
                    self.forward()
                elif ch in _ESCAPE_CODES:
                    n = _ESCAPE_CODES[ch]
                    self.forward()
                    for k in range(n):
                        if self.peek(k) not in _HEX:
                            self.fail(f"a double-quoted scalar: expected escape sequence of "
                                      f"{n} hexadecimal numbers, but found {self.peek(k)!r}")
                    chunks.append(chr(int(self.prefix(n), 16)))
                    self.forward(n)
                elif ch in _BREAKS:
                    self.scan_line_break()
                    chunks.extend(self.scan_flow_breaks(line))
                else:
                    self.fail(f"a double-quoted scalar: found unknown escape character "
                              f"{ch!r}")
            else:
                return chunks

    def scan_flow_spaces(self, double: bool, line: int) -> List[str]:
        n = 0
        while self.peek(n) in " \t":
            n += 1
        spaces = self.prefix(n)
        self.forward(n)
        ch = self.peek()
        if ch == "\0":
            self.fail("an unclosed quoted scalar: found unexpected end of stream", line)
        if ch in _BREAKS:
            line_break = self.scan_line_break()
            breaks = self.scan_flow_breaks(line)
            chunks = []
            if line_break != "\n":
                chunks.append(line_break)
            elif not breaks:
                chunks.append(" ")
            return chunks + breaks
        return [spaces]

    def at_document_marker(self) -> bool:
        return self.prefix(3) in ("---", "...") and self.peek(3) in _BLANK_END

    def scan_flow_breaks(self, line: int) -> List[str]:
        chunks = []
        while True:
            if self.at_document_marker():
                self.fail("a quoted scalar: found unexpected document separator", line)
            while self.peek() in " \t":
                self.forward()
            if self.peek() in _BREAKS:
                chunks.append(self.scan_line_break())
            else:
                return chunks

    def scan_plain(self) -> _Tok:
        chunks: List[str] = []
        line = self.line
        indent = self.indent + 1
        spaces: Optional[List[str]] = []
        ends = _BLANK_END + (",[]{}" if self.flow_level else "")
        while self.peek() != "#":
            n = 0
            while True:
                ch = self.peek(n)
                if (ch in _BLANK_END or (ch == ":" and self.peek(n + 1) in ends)
                        or (self.flow_level and ch in ",?[]{}")):
                    break
                n += 1
            if n == 0:
                break
            self.allow_simple_key = False
            chunks.extend(spaces)
            chunks.append(self.prefix(n))
            self.forward(n)
            spaces = self.scan_plain_spaces()
            if (not spaces or self.peek() == "#"
                    or (not self.flow_level and self.column < indent)):
                break
        return _Tok("scalar", line, "".join(chunks), True)

    def scan_plain_spaces(self) -> Optional[List[str]]:
        n = 0
        while self.peek(n) == " ":
            n += 1
        spaces = self.prefix(n)
        self.forward(n)
        if self.peek() in _BREAKS:
            line_break = self.scan_line_break()
            self.allow_simple_key = True
            if self.at_document_marker():
                return None
            breaks = []
            while self.peek() in " " + _BREAKS:
                if self.peek() == " ":
                    self.forward()
                else:
                    breaks.append(self.scan_line_break())
                    if self.at_document_marker():
                        return None
            chunks = []
            if line_break != "\n":
                chunks.append(line_break)
            elif not breaks:
                chunks.append(" ")
            return chunks + breaks
        return [spaces] if spaces else []


class _Parser:
    """PyYAML's parser and composer in one recursive pass: tokens to the node
    graph of the stream's single document."""

    DEFAULT_TAGS = {"!": "!", "!!": _TAG}

    def __init__(self, scanner: _Scanner):
        self.s = scanner
        self.tag_handles = dict(self.DEFAULT_TAGS)
        self.anchors: Dict[str, _Node] = {}

    def fail(self, what: str, line: int):
        self.s.fail(what, line)

    def document(self) -> Optional[_Node]:
        s = self.s
        s.get_token()  # stream start
        node = None
        if not s.check("directive", "document-start", "stream-end"):
            node = self.node(block=True)
            if s.check("document-end"):
                s.get_token()
        else:
            while s.check("document-end"):
                s.get_token()
            if not s.check("stream-end"):
                self.directives()
                if not s.check("document-start"):
                    tok = s.peek_token()
                    self.fail(f"a document: expected '<document start>', but found "
                              f"{tok.id!r}", tok.line)
                s.get_token()
                if s.check("directive", "document-start", "document-end", "stream-end"):
                    node = self.empty(s.peek_token().line)
                else:
                    node = self.node(block=True)
                if s.check("document-end"):
                    s.get_token()
        while s.check("document-end"):
            s.get_token()
        if not s.check("stream-end"):
            tok = s.peek_token()
            if s.check("directive", "document-start"):
                self.fail("a second document: expected a single document in the stream",
                          tok.line)
            self.fail(f"the stream: expected '<document start>', but found {tok.id!r}",
                      tok.line)
        return node

    def directives(self) -> None:
        s, version, handles = self.s, None, {}
        while s.check("directive"):
            tok = s.get_token()
            name, value = tok.value
            if name == "YAML":
                if version is not None:
                    self.fail("a YAML directive: found duplicate YAML directive", tok.line)
                if value[0] != 1:
                    self.fail("a YAML directive: found incompatible YAML document (version "
                              "1.* is required)", tok.line)
                version = value
            elif name == "TAG":
                if value[0] in handles:
                    self.fail(f"a TAG directive: duplicate tag handle {value[0]!r}", tok.line)
                handles[value[0]] = value[1]
        self.tag_handles = {**self.DEFAULT_TAGS, **handles}

    def empty(self, line: int) -> _Node:
        return _Node("scalar", _resolve_scalar("", True), "", line)

    def node(self, block: bool = False, indentless: bool = False) -> _Node:
        s = self.s
        if s.check("alias"):
            tok = s.get_token()
            if tok.value not in self.anchors:
                self.fail(f"an alias: found undefined alias {tok.value!r}", tok.line)
            return self.anchors[tok.value]
        anchor = tag = None
        line = s.peek_token().line
        for _ in range(2):
            if anchor is None and s.check("anchor"):
                anchor = s.get_token().value
            elif tag is None and s.check("tag"):
                tok = s.get_token()
                handle, suffix = tok.value
                if handle is not None:
                    if handle not in self.tag_handles:
                        self.fail(f"a node: found undefined tag handle {handle!r}", tok.line)
                    tag = self.tag_handles[handle] + suffix
                else:
                    tag = suffix
        if anchor is not None and anchor in self.anchors:
            self.fail(f"an anchor: found duplicate anchor {anchor!r}", line)
        nonspecific = tag is None or tag == "!"
        if indentless and s.check("block-entry"):
            node = _Node("seq", _TAG + "seq" if nonspecific else tag, [], line)
            self.register(anchor, node)
            while s.check("block-entry"):
                tok = s.get_token()
                if not s.check("block-entry", "key", "value", "block-end"):
                    node.value.append(self.node(block=True))
                else:
                    node.value.append(self.empty(tok.line))
            return node
        if s.check("scalar"):
            tok = s.get_token()
            if nonspecific:
                tag = _resolve_scalar(tok.value, (tok.plain and tag is None) or tag == "!")
            node = _Node("scalar", tag, tok.value, tok.line)
            self.register(anchor, node)
            return node
        if s.check("flow-sequence-start", "block-sequence-start") and (
                block or s.check("flow-sequence-start")):
            node = _Node("seq", _TAG + "seq" if nonspecific else tag, [], line)
            self.register(anchor, node)
            if s.get_token().id == "flow-sequence-start":
                self.flow_sequence(node)
            else:
                self.block_sequence(node)
            return node
        if s.check("flow-mapping-start", "block-mapping-start") and (
                block or s.check("flow-mapping-start")):
            node = _Node("map", _TAG + "map" if nonspecific else tag, [], line)
            self.register(anchor, node)
            if s.get_token().id == "flow-mapping-start":
                self.flow_mapping(node)
            else:
                self.block_mapping(node)
            return node
        if anchor is not None or tag is not None:
            node = _Node("scalar", _resolve_scalar("", nonspecific) if nonspecific else tag,
                         "", line)
            self.register(anchor, node)
            return node
        tok = s.peek_token()
        self.fail(f"a {'block' if block else 'flow'} node: expected the node content, but "
                  f"found {_describe(tok)}", tok.line)

    def register(self, anchor: Optional[str], node: _Node) -> None:
        if anchor is not None:
            self.anchors[anchor] = node

    def block_sequence(self, node: _Node) -> None:
        s = self.s
        while s.check("block-entry"):
            tok = s.get_token()
            if not s.check("block-entry", "block-end"):
                node.value.append(self.node(block=True))
            else:
                node.value.append(self.empty(tok.line))
        if not s.check("block-end"):
            tok = s.peek_token()
            self.fail(f"a block collection: expected <block end>, but found "
                      f"{_describe(tok)}", tok.line)
        s.get_token()

    def block_mapping(self, node: _Node) -> None:
        s = self.s
        while True:
            if s.check("key"):
                tok = s.get_token()
                if not s.check("key", "value", "block-end"):
                    key = self.node(block=True, indentless=True)
                else:
                    key = self.empty(tok.line)
            else:
                break
            if s.check("value"):
                tok = s.get_token()
                if not s.check("key", "value", "block-end"):
                    value = self.node(block=True, indentless=True)
                else:
                    value = self.empty(tok.line)
            else:
                value = self.empty(s.peek_token().line)
            node.value.append((key, value))
        if not s.check("block-end"):
            tok = s.peek_token()
            self.fail(f"a block mapping: expected <block end>, but found {_describe(tok)}",
                      tok.line)
        s.get_token()

    def flow_sequence(self, node: _Node) -> None:
        s, first = self.s, True
        while not s.check("flow-sequence-end"):
            if not first:
                if s.check("flow-entry"):
                    s.get_token()
                else:
                    self.flow_fail("sequence", "]")
            first = False
            if s.check("key"):
                tok = s.get_token()
                pair = _Node("map", _TAG + "map", [], tok.line)
                if not s.check("value", "flow-entry", "flow-sequence-end"):
                    key = self.node()
                else:
                    key = self.empty(tok.line)
                pair.value.append((key, self.flow_value("flow-entry", "flow-sequence-end")))
                node.value.append(pair)
            elif not s.check("flow-sequence-end"):
                node.value.append(self.node())
        s.get_token()

    def flow_value(self, *ends) -> _Node:
        s = self.s
        if s.check("value"):
            tok = s.get_token()
            if not s.check(*ends):
                return self.node()
            return self.empty(tok.line)
        return self.empty(s.peek_token().line)

    def flow_mapping(self, node: _Node) -> None:
        s, first = self.s, True
        while not s.check("flow-mapping-end"):
            if not first:
                if s.check("flow-entry"):
                    s.get_token()
                else:
                    self.flow_fail("mapping", "}")
            first = False
            if s.check("key"):
                tok = s.get_token()
                if not s.check("value", "flow-entry", "flow-mapping-end"):
                    key = self.node()
                else:
                    key = self.empty(tok.line)
                node.value.append((key, self.flow_value("flow-entry", "flow-mapping-end")))
            elif not s.check("flow-mapping-end"):
                key = self.node()
                node.value.append((key, self.empty(s.peek_token().line)))
        s.get_token()

    def flow_fail(self, kind: str, close: str):
        tok = self.s.peek_token()
        if tok.id == "stream-end":
            self.fail(f"an unclosed flow {kind}: expected ',' or '{close}', but found "
                      "<stream end>", tok.line)
        self.fail(f"a flow {kind}: expected ',' or '{close}', but found {_describe(tok)}",
                  tok.line)


def _describe(tok: _Tok) -> str:
    return f"<{tok.id}>" if tok.id != "scalar" else "a scalar"


def _resolve_scalar(value: str, implicit: bool) -> str:
    if implicit:
        first = value[:1]
        for name, regexp, chars in _RESOLVERS:
            if (first in chars if value else name == "null") and regexp.match(value):
                return _TAG + name
    return _TAG + "str"


class _Constructor:
    """PyYAML's SafeConstructor over the node graph: one object per node, so
    an alias gives the object of its anchor."""

    def __init__(self, name: str):
        self.name = name
        self.objects: Dict[int, object] = {}
        self.building: set = set()

    def fail(self, what: str, line: int):
        raise _Error(f"{self.name}, line {line + 1}: cannot read {what}")

    def build(self, node: _Node):
        key = id(node)
        if key in self.objects:
            return self.objects[key]
        if key in self.building:
            self.fail("a node: found unconstructable recursive node", node.line)
        tag = node.tag
        suffix = tag[len(_TAG):] if tag.startswith(_TAG) else None
        if suffix in ("seq", "map", "set", "omap", "pairs"):
            # the container first, filled after: a node may hold an alias of itself
            obj = set() if suffix == "set" else ({} if suffix == "map" else [])
            self.objects[key] = obj
            getattr(self, "fill_" + suffix)(obj, node)
            return obj
        self.building.add(key)
        try:
            maker = getattr(self, "make_" + suffix, None) if suffix else None
            if maker is None:
                self.fail(f"the tag {tag!r}: could not determine a constructor for it",
                          node.line)
            obj = maker(node)
        finally:
            self.building.discard(key)
        self.objects[key] = obj
        return obj

    def scalar(self, node: _Node) -> str:
        if node.kind == "map":
            for key_node, value_node in node.value:
                if key_node.tag == _TAG + "value":
                    return self.scalar(value_node)
        if node.kind != "scalar":
            self.fail(f"a {node.tag}: expected a scalar node, but found {node.kind}",
                      node.line)
        return node.value

    def flatten(self, node: _Node) -> None:
        merge, index = [], 0
        while index < len(node.value):
            key_node, value_node = node.value[index]
            if key_node.tag == _TAG + "merge":
                del node.value[index]
                if value_node.kind == "map":
                    self.flatten(value_node)
                    merge.extend(value_node.value)
                elif value_node.kind == "seq":
                    sub = []
                    for subnode in value_node.value:
                        if subnode.kind != "map":
                            self.fail(f"a mapping: expected a mapping for merging, but found "
                                      f"{subnode.kind}", subnode.line)
                        self.flatten(subnode)
                        sub.append(subnode.value)
                    for value in reversed(sub):
                        merge.extend(value)
                else:
                    self.fail(f"a mapping: expected a mapping or list of mappings for "
                              f"merging, but found {value_node.kind}", value_node.line)
            else:
                if key_node.tag == _TAG + "value":
                    key_node.tag = _TAG + "str"
                index += 1
        if merge:
            node.value = merge + node.value

    def mapping_items(self, node: _Node, what: str):
        if node.kind != "map":
            self.fail(f"{what}: expected a mapping node, but found {node.kind}", node.line)
        self.flatten(node)
        for key_node, value_node in node.value:
            key = self.build(key_node)
            try:
                hash(key)
            except TypeError:
                self.fail("a mapping: found unhashable key", key_node.line)
            yield key, value_node

    def fill_map(self, obj: dict, node: _Node) -> None:
        for key, value_node in self.mapping_items(node, "a mapping"):
            obj[key] = self.build(value_node)

    def fill_set(self, obj: set, node: _Node) -> None:
        for key, value_node in self.mapping_items(node, "a set"):
            self.build(value_node)
            obj.add(key)

    def fill_seq(self, obj: list, node: _Node) -> None:
        if node.kind != "seq":
            self.fail(f"a sequence: expected a sequence node, but found {node.kind}", node.line)
        obj.extend(self.build(child) for child in node.value)

    def fill_omap(self, obj: list, node: _Node, what: str = "an ordered map") -> None:
        if node.kind != "seq":
            self.fail(f"{what}: expected a sequence, but found {node.kind}", node.line)
        for sub in node.value:
            if sub.kind != "map" or len(sub.value) != 1:
                self.fail(f"{what}: expected a single mapping item", sub.line)
            key_node, value_node = sub.value[0]
            obj.append((self.build(key_node), self.build(value_node)))

    def fill_pairs(self, obj: list, node: _Node) -> None:
        self.fill_omap(obj, node, "pairs")

    def make_str(self, node):
        return self.scalar(node)

    def make_null(self, node):
        self.scalar(node)
        return None

    def make_bool(self, node):
        value = self.scalar(node).lower()
        if value not in _BOOL_VALUES:
            self.fail(f"a bool: {value!r} is none of {sorted(_BOOL_VALUES)}", node.line)
        return _BOOL_VALUES[value]

    def make_int(self, node):
        value = self.scalar(node).replace("_", "")
        try:
            sign = -1 if value[0] == "-" else 1
            if value[0] in "+-":
                value = value[1:]
            if value == "0":
                return 0
            if value.startswith("0b"):
                return sign * int(value[2:], 2)
            if value.startswith("0x"):
                return sign * int(value[2:], 16)
            if value[0] == "0":
                return sign * int(value, 8)
            if ":" in value:
                return sign * _base60(value, int)
            return sign * int(value)
        except (IndexError, ValueError) as exc:
            self.fail(f"an int: {exc}", node.line)

    def make_float(self, node):
        value = self.scalar(node).replace("_", "").lower()
        try:
            sign = -1 if value[0] == "-" else 1
            if value[0] in "+-":
                value = value[1:]
            if value == ".inf":
                return sign * _INF
            if value == ".nan":
                return _NAN
            if ":" in value:
                return sign * _base60(value, float)
            return sign * float(value)
        except (IndexError, ValueError) as exc:
            self.fail(f"a float: {exc}", node.line)

    def make_binary(self, node):
        try:
            return base64.decodebytes(self.scalar(node).encode("ascii"))
        except (UnicodeEncodeError, binascii.Error) as exc:
            self.fail(f"binary data: {exc}", node.line)

    def make_timestamp(self, node):
        self.scalar(node)
        match = _TIMESTAMP.match(node.value)
        if match is None:
            self.fail(f"a timestamp: {node.value!r}", node.line)
        v = match.groupdict()
        try:
            year, month, day = int(v["year"]), int(v["month"]), int(v["day"])
            if not v["hour"]:
                return datetime.date(year, month, day)
            fraction = int(v["fraction"][:6].ljust(6, "0")) if v["fraction"] else 0
            tzinfo = None
            if v["tz_sign"]:
                delta = datetime.timedelta(hours=int(v["tz_hour"]),
                                           minutes=int(v["tz_minute"] or 0))
                tzinfo = datetime.timezone(-delta if v["tz_sign"] == "-" else delta)
            elif v["tz"]:
                tzinfo = datetime.timezone.utc
            return datetime.datetime(year, month, day, int(v["hour"]), int(v["minute"]),
                                     int(v["second"]), fraction, tzinfo=tzinfo)
        except ValueError as exc:
            self.fail(f"a timestamp: {exc}", node.line)


_BOOL_VALUES = {"yes": True, "no": False, "true": True, "false": False, "on": True,
                "off": False}
_INF = float("inf")
_NAN = float("nan")


def _base60(text: str, cast):
    value, base = cast(0), 1
    for digit in reversed([cast(part) for part in text.split(":")]):
        value += digit * base
        base *= 60
    return value


def loads(text: str, name: str = "<yaml>"):
    """What yaml.safe_load gives for the single-document stream `text`."""
    node = _Parser(_Scanner(text, name)).document()
    return None if node is None else _Constructor(name).build(node)


def read_yaml(path: str):
    """What yaml.safe_load gives for the YAML file at `path`."""
    with open(path) as f:
        return loads(f.read(), str(path))
