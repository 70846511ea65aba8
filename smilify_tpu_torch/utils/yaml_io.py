"""YAML stage files in the standard library, without PyYAML.

The port does not depend on PyYAML (the card's machine need not have it),
and the registration CLI (``cli/optimise_3d.py``) reads its stages from a
YAML file. :func:`safe_load`
reads the subset of YAML that such files use and returns what PyYAML 6's
``yaml.safe_load`` returns for them:

  * block mappings and block sequences by indentation (a sequence may sit at
    its key's indentation, as ``yaml.safe_dump`` writes it), compact nesting
    (``- - a``, ``- k: v``), flow mappings and sequences nested to any depth
    and across lines, single-pair mappings in a flow sequence (``[k: v]``);
  * plain, single-quoted and double-quoted scalars, every escape of the
    double-quoted style, line folding of multi-line scalars; ``#`` comments;
    one optional ``---`` and an optional ``...``; empty values (null);
  * plain scalars resolved as PyYAML's YAML 1.1 resolver does: ``yes``,
    ``no``, ``on`` and ``off`` are booleans, ``~`` and ``null`` are null,
    ``017`` is octal, ``0x1F`` hex, ``0b101`` binary, ``1:30`` and
    ``1:30.5`` sexagesimal, ``.inf`` and ``.nan`` floats, and a float needs
    its dot (``1e-3`` and ``1.0e3`` stay strings; ``1.0e-3`` is a float).

What it does not read it refuses: ``NotImplementedError`` naming the
construct (anchors and aliases, tags, block scalars ``|`` and ``>``, more
than one document, ``?`` complex keys, ``<<`` merge keys, timestamps,
directives, collections as mapping keys), never another value. Input that
PyYAML rejects as malformed raises ``ValueError``.
"""

from __future__ import annotations

import re
from typing import Any, List

__all__ = ["safe_load"]

# PyYAML's implicit resolvers (yaml/resolver.py, YAML 1.1), each tried only
# for the first characters listed beside it, in this order
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)"
                    r"|\.(?:nan|NaN|NAN))$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+"
                  r"|[-+]?0[0-7_]+"
                  r"|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+"
                  r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_MERGE = re.compile(r"^(?:<<)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
                        r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
                        r"(?:[Tt]|[ \t]+)[0-9][0-9]?"
                        r":[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
                        r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$")
_VALUE = re.compile(r"^(?:=)$")
_RESOLVERS = (("bool", _BOOL, "yYnNtTfFoO"), ("float", _FLOAT, "-+0123456789."),
              ("int", _INT, "-+0123456789"), ("merge", _MERGE, "<"),
              ("null", _NULL, "~nN"), ("timestamp", _TIMESTAMP, "0123456789"),
              ("value", _VALUE, "="))
_BOOLS = {"yes": True, "no": False, "true": True, "false": False, "on": True, "off": False}

# the double-quoted style's escapes (yaml/scanner.py)
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "\\": "\\", "/": "/", "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_HEX = set("0123456789ABCDEFabcdef")
# characters PyYAML's reader refuses
_NON_PRINTABLE = re.compile("[^\x09\x0a\x0d\x20-\x7e\x85\xa0-\ud7ff\ue000-\ufffd"
                            "\U00010000-\U0010ffff]")
_END = ("", " ", "\n")
_FLOW_INDICATORS = ",[]{}"


def _construct_int(text: str) -> int:
    value = text.replace("_", "")
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
        total, base = 0, 1
        for part in reversed(value.split(":")):
            total += int(part) * base
            base *= 60
        return sign * total
    return sign * int(value)


def _construct_float(text: str) -> float:
    value = text.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        total, base = 0.0, 1
        for part in reversed(value.split(":")):
            total += float(part) * base
            base *= 60
        return sign * total
    return sign * float(value)


def _resolve(text: str) -> Any:
    """A plain scalar's value, as PyYAML's resolver and SafeConstructor give it."""
    for kind, pattern, first in _RESOLVERS:
        if (text[:1] in first if text else kind == "null") and pattern.match(text):
            if kind == "bool":
                return _BOOLS[text.lower()]
            if kind == "float":
                return _construct_float(text)
            if kind == "int":
                return _construct_int(text)
            if kind == "null":
                return None
            raise NotImplementedError(
                {"merge": "merge keys (<<)", "timestamp": f"timestamps ({text!r})",
                 "value": "the value key (=)"}[kind])
    return text


class _Scalar:
    """A scalar node: its value, and whether it spanned lines (no key then)."""

    __slots__ = ("value", "multiline")

    def __init__(self, value, multiline):
        self.value, self.multiline = value, multiline


class _Parser:
    def __init__(self, text: str):
        if text.startswith("\ufeff"):
            text = text[1:]
        bad = _NON_PRINTABLE.search(text)
        if bad:
            raise ValueError(f"YAML: unacceptable character {bad.group()!r}")
        for ch, name in (("\u2028", "LS"), ("\u2029", "PS")):
            if ch in text:
                raise NotImplementedError(f"the line break {name} ({ch!r}) in YAML")
        # PyYAML reads CR LF, CR and NEL as LF wherever they stand
        text = text.replace("\r\n", "\n").replace("\r", "\n").replace("\x85", "\n")
        self.s = text
        self.i = 0

    # -- position ------------------------------------------------------------
    def peek(self, k: int = 0) -> str:
        j = self.i + k
        return self.s[j] if j < len(self.s) else ""

    def column(self, i=None) -> int:
        i = self.i if i is None else i
        return i - (self.s.rfind("\n", 0, i) + 1)

    def error(self, msg: str):
        line = self.s.count("\n", 0, self.i) + 1
        return ValueError(f"YAML: {msg} (line {line}, column {self.column() + 1})")

    def skip_to_content(self) -> None:
        """Past spaces, comments and line breaks (PyYAML's scan_to_next_token)."""
        while True:
            while self.peek() == " ":
                self.i += 1
            if self.peek() == "#":
                end = self.s.find("\n", self.i)
                self.i = len(self.s) if end < 0 else end
            if self.peek() == "\n":
                self.i += 1
            elif self.peek() == "\t":
                raise self.error("a tab cannot start a token")
            else:
                return

    def newline_between(self, start: int) -> bool:
        return "\n" in self.s[start:self.i]

    def at_document_marker(self) -> str:
        if self.column() == 0 and self.s[self.i:self.i + 3] in ("---", "...") \
                and self.peek(3) in _END:
            return self.s[self.i:self.i + 3]
        return ""

    # -- document ------------------------------------------------------------
    def document(self) -> Any:
        self.skip_to_content()
        if self.peek() == "%" and self.column() == 0:
            raise NotImplementedError("YAML directives (%)")
        marker = self.at_document_marker() == "---"
        if marker:
            self.i += 3
        value = self.block_node(-1, flow_only_here=marker)
        self.skip_to_content()
        if self.at_document_marker() == "...":
            self.i += 3
            self.skip_to_content()
        if self.i < len(self.s):
            if self.at_document_marker() or self.peek() == "%":
                raise NotImplementedError("more than one YAML document")
            raise self.error(f"unexpected {self.peek()!r} after the document")
        return value

    # -- block context -------------------------------------------------------
    def refuse_indicator(self, flow: bool) -> None:
        c, nxt = self.peek(), self.peek(1)
        if not c:
            raise self.error("expected a node, found the end")
        if c in "&*":
            raise NotImplementedError("YAML anchors and aliases (& and *)")
        if c == "!":
            raise NotImplementedError("YAML tags (!)")
        if c in "|>" and not flow:
            raise NotImplementedError(f"YAML block scalars ({c})")
        if c == "?" and (flow or nxt in _END):
            raise NotImplementedError("YAML complex keys (?)")
        if c in "@`|>%" or (c in _FLOW_INDICATORS and c not in "[{") or (
                c in "-:" and nxt in _END):
            raise self.error(f"{c!r} cannot start a node")

    def block_node(self, indent: int, flow_only_here: bool = False) -> Any:
        """The node after ``key:``, ``- `` or the document start, inside a
        block collection at column ``indent`` (-1 for the root). Where
        ``flow_only_here``, a node on the cursor's line is a scalar or a flow
        collection, and a sequence on the next lines may sit at ``indent``."""
        start = self.i
        self.skip_to_content()
        if self.i >= len(self.s) or self.at_document_marker():
            return None
        col = self.column()
        dash = self.peek() == "-" and self.peek(1) in _END
        if self.newline_between(start):
            if col < indent or (col == indent and not (dash and flow_only_here)):
                return None       # an empty value: the next entry of a collection
        elif flow_only_here:
            if dash:
                raise self.error("sequence entries are not allowed here")
            node = self.inline_node(indent, flow=False)
            self.end_of_line_after()
            return self.value_of(node)
        if dash:
            return self.block_sequence(col, indentless=col == indent)
        node = self.inline_node(indent, flow=False)
        while self.peek() == " ":
            self.i += 1
        if self.peek() == ":" and self.peek(1) in _END:
            return self.block_mapping(col, node)
        self.end_of_line_after()
        return self.value_of(node)

    def inline_node(self, indent: int, flow: bool):
        """A scalar (as a :class:`_Scalar`) or a flow collection, at the cursor."""
        self.refuse_indicator(flow)
        c = self.peek()
        if c == "[":
            return self.flow_sequence()
        if c == "{":
            return self.flow_mapping()
        if c in "'\"":
            return self.quoted()
        return self.plain(indent, flow)

    def end_of_line_after(self) -> None:
        """After a node in block context: spaces, a comment, a line break."""
        while self.peek() == " ":
            self.i += 1
        if self.peek() == ":" and self.peek(1) in _END:
            raise self.error("mapping values are not allowed here")
        if self.peek() not in ("", "\n", "#"):
            raise self.error(f"unexpected {self.peek()!r}")

    def key_of(self, node) -> Any:
        if not isinstance(node, _Scalar):
            raise NotImplementedError("YAML collections as mapping keys")
        if node.multiline:
            raise self.error("a key cannot span lines")
        return node.value

    def block_mapping(self, col: int, first) -> dict:
        out = {}
        node = first
        while True:
            key = self.key_of(node)
            self.i += 1                                   # the ':'
            out[key] = self.block_node(col, flow_only_here=True)
            self.skip_to_content()
            if self.i >= len(self.s) or self.at_document_marker() or self.column() < col:
                return out
            if self.column() > col:
                raise self.error("bad indentation of a mapping entry")
            if self.peek() == "-" and self.peek(1) in _END:
                raise self.error("a sequence entry where a mapping key was expected")
            node = self.inline_node(col, flow=False)
            while self.peek() == " ":
                self.i += 1
            if not (self.peek() == ":" and self.peek(1) in _END):
                raise self.error("could not find the expected ':'")

    def block_sequence(self, col: int, indentless: bool) -> list:
        out = []
        while True:
            self.i += 1                                   # the '-'
            out.append(self.block_node(col))
            self.skip_to_content()
            if self.i >= len(self.s) or self.at_document_marker() or self.column() < col:
                return out
            if self.column() > col:
                raise self.error("bad indentation of a sequence entry")
            if not (self.peek() == "-" and self.peek(1) in _END):
                if indentless:
                    return out            # the enclosing mapping's next key
                raise self.error("expected a sequence entry '- '")

    # -- flow context --------------------------------------------------------
    def flow_node(self) -> Any:
        self.skip_to_content()
        if self.peek() in ("", ",", "]", "}", ":"):
            raise self.error(f"expected a node, found {self.peek() or 'the end'!r}")
        return self.inline_node(-1, flow=True)

    def value_of(self, node) -> Any:
        return node.value if isinstance(node, _Scalar) else node

    def flow_sequence(self) -> list:
        self.i += 1
        out = []
        while True:
            self.skip_to_content()
            if self.peek() == "]":
                self.i += 1
                return out
            node = self.flow_node()
            self.skip_to_content()
            if self.peek() == ":":                       # a single-pair mapping
                self.i += 1
                self.skip_to_content()
                value = None if self.peek() in ",]" else self.value_of(self.flow_node())
                out.append({self.key_of(node): value})
                self.skip_to_content()
            else:
                out.append(self.value_of(node))
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "]":
                raise self.error("expected ',' or ']' in a flow sequence")

    def flow_mapping(self) -> dict:
        self.i += 1
        out = {}
        while True:
            self.skip_to_content()
            if self.peek() == "}":
                self.i += 1
                return out
            key = self.key_of(self.flow_node())
            self.skip_to_content()
            value = None
            if self.peek() == ":":
                self.i += 1
                self.skip_to_content()
                if self.peek() not in ",}":
                    value = self.value_of(self.flow_node())
                self.skip_to_content()
            out[key] = value
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "}":
                raise self.error("expected ',' or '}' in a flow mapping")

    # -- scalars -------------------------------------------------------------
    def plain(self, indent: int, flow: bool) -> _Scalar:
        """A plain scalar (PyYAML's scan_plain): it ends at ': ', ' #', a
        flow indicator in flow context, a document marker, or a line less
        indented than ``indent + 1`` in block context."""
        stop = _FLOW_INDICATORS + "?" if flow else ""
        chunks: List[str] = []
        spaces: List[str] = []
        start = self.i
        end = self.i
        while self.peek() != "#":
            n = 0
            while True:
                ch = self.peek(n)
                if ch in ("", " ", "\t", "\n") or ch in stop or (
                        ch == ":" and (self.peek(n + 1) in _END or self.peek(n + 1) == "\t"
                                       or (flow and self.peek(n + 1) in _FLOW_INDICATORS))):
                    break
                n += 1
            if n == 0:
                break
            chunks.extend(spaces)
            chunks.append(self.s[self.i:self.i + n])
            self.i += n
            end = self.i
            spaces = self.plain_spaces()
            if not spaces or self.peek() == "#" or (not flow and self.column() < indent + 1):
                break
        if not chunks:
            raise self.error(f"{self.peek()!r} cannot start a plain scalar")
        text = "".join(chunks)
        self.i = end
        return _Scalar(_resolve(text), "\n" in self.s[start:end])

    def plain_spaces(self) -> List[str]:
        n = 0
        while self.peek(n) == " ":
            n += 1
        whitespace = self.s[self.i:self.i + n]
        self.i += n
        if self.peek() != "\n":
            return [whitespace] if whitespace else []
        self.i += 1
        if self.at_document_marker():
            return []
        breaks = []
        while self.peek() in (" ", "\n") and self.peek():
            if self.peek() == " ":
                self.i += 1
            else:
                self.i += 1
                breaks.append("\n")
                if self.at_document_marker():
                    return []
        return breaks if breaks else [" "]

    def quoted(self) -> _Scalar:
        """A single- or double-quoted scalar (PyYAML's scan_flow_scalar)."""
        quote = self.peek()
        double = quote == '"'
        start = self.i
        self.i += 1
        chunks = self.quoted_non_spaces(double)
        while self.peek() != quote:
            chunks.extend(self.quoted_spaces())
            chunks.extend(self.quoted_non_spaces(double))
        self.i += 1
        return _Scalar("".join(chunks), "\n" in self.s[start:self.i])

    def quoted_non_spaces(self, double: bool) -> List[str]:
        chunks = []
        while True:
            n = 0
            while self.peek(n) not in ("", "'", '"', "\\", " ", "\t", "\n"):
                n += 1
            if n:
                chunks.append(self.s[self.i:self.i + n])
                self.i += n
            ch = self.peek()
            if not double and ch == "'" and self.peek(1) == "'":
                chunks.append("'")
                self.i += 2
            elif (double and ch == "'") or (not double and ch in ('"', "\\")):
                chunks.append(ch)
                self.i += 1
            elif double and ch == "\\":
                e = self.peek(1)
                if e in _ESCAPES:
                    chunks.append(_ESCAPES[e])
                    self.i += 2
                elif e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    digits = self.s[self.i + 2:self.i + 2 + n]
                    if len(digits) != n or not set(digits) <= _HEX:
                        raise self.error(f"expected {n} hexadecimal digits after \\{e}")
                    chunks.append(chr(int(digits, 16)))
                    self.i += 2 + n
                elif e == "\n":
                    self.i += 2
                    chunks.extend(self.quoted_breaks())
                else:
                    raise self.error(f"unknown escape \\{e}")
            else:
                return chunks

    def quoted_spaces(self) -> List[str]:
        n = 0
        while self.peek(n) in (" ", "\t") and self.peek(n):
            n += 1
        whitespace = self.s[self.i:self.i + n]
        self.i += n
        if self.peek() == "":
            raise self.error("unexpected end of the stream in a quoted scalar")
        if self.peek() == "\n":
            self.i += 1
            breaks = self.quoted_breaks()
            return breaks if breaks else [" "]
        return [whitespace]

    def quoted_breaks(self) -> List[str]:
        breaks = []
        while True:
            if self.at_document_marker():
                raise self.error("a document marker inside a quoted scalar")
            while self.peek() in (" ", "\t") and self.peek():
                self.i += 1
            if self.peek() == "\n":
                self.i += 1
                breaks.append("\n")
            else:
                return breaks


def safe_load(text_or_stream) -> Any:
    """What ``yaml.safe_load`` returns for a document of the subset in the
    module's docstring: a ``str``, ``bytes`` (UTF-8) or an object with
    ``read()``. Refused constructs raise ``NotImplementedError`` naming
    them; malformed input raises ``ValueError``."""
    data = text_or_stream.read() if hasattr(text_or_stream, "read") else text_or_stream
    if isinstance(data, bytes):
        data = data.decode("utf-8")
    return _Parser(data).document()
