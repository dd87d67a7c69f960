"""The port's own YAML reader and writer, for the subset ``configs/`` uses.

The card's machine has no PyYAML, so the config engine cannot lean on it.
:func:`loads` reads:

- block mappings and block sequences, nested by indentation, including
  sequences of mappings (``- name: X`` followed by its indented keys) and
  a sequence at its parent key's indentation;
- flow sequences and mappings (``[0.5, 1.0]``, ``['a', "b"]``, ``{}``);
- single- and double-quoted scalars, plain scalars (``${...}`` included),
  full-line and trailing comments, blank lines.

Plain scalars resolve as the JAX package's loader resolves them (YAML 1.1
as PyYAML's ``SafeLoader`` has it, with ``1e-6`` read as a float): null,
bool (``true``, ``yes``, ``off``...), int (decimal, ``0x``, ``0b``, octal
``0..``, ``1_000``, base 60), float, timestamp, else string. Anything
outside the subset (anchors, aliases, tags, block scalars, multi-line
plain scalars, several documents, complex keys) raises :class:`YAMLError`
with the file and line; nothing is guessed.

:func:`dumps` writes block YAML that PyYAML's ``safe_load``, the JAX
package's ``load_yaml`` and :func:`loads` all read back to the same value.
"""

from __future__ import annotations

import datetime
import json
import math
import re
from typing import Any, List, Optional, Tuple

__all__ = ["YAMLError", "dumps", "load", "loads"]


class YAMLError(ValueError):
    """A document outside the subset the reader takes."""


_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on",
                           "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE",
                                 "off", "Off", "OFF")})
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
# PyYAML's float, and the JAX loader's wider one (an exponent without a dot)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_DATE = re.compile(r"^(?P<year>[0-9]{4})-(?P<month>[0-9]{2})-(?P<day>[0-9]{2})$")
_TIMESTAMP = re.compile(r"""^(?P<year>[0-9]{4})-(?P<month>[0-9]{1,2})-(?P<day>[0-9]{1,2})
    (?:[Tt]|[ \t]+)(?P<hour>[0-9]{1,2}):(?P<minute>[0-9]{2}):(?P<second>[0-9]{2})
    (?:\.(?P<fraction>[0-9]*))?
    (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9]{1,2})(?::(?P<tz_minute>[0-9]{2}))?))?$""",
                        re.X)


def _sexagesimal(text: str, cast) -> Any:
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    value, base = 0, 1
    for part in reversed(text.split(":")):
        value += cast(part) * base
        base *= 60
    return sign * value


def _int(text: str) -> int:
    text = text.replace("_", "")
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    if text == "0":
        return 0
    if text.startswith("0b"):
        return sign * int(text[2:], 2)
    if text.startswith("0x"):
        return sign * int(text[2:], 16)
    if text[0] == "0":
        return sign * int(text, 8)
    if ":" in text:
        return sign * _sexagesimal(text, int)
    return sign * int(text)


def _float(text: str) -> float:
    text = text.replace("_", "").lower()
    sign = -1.0 if text[0] == "-" else 1.0
    if text[0] in "+-":
        text = text[1:]
    if text == ".inf":
        return sign * math.inf
    if text == ".nan":
        return math.nan
    if ":" in text:
        return sign * _sexagesimal(text, float)
    return sign * float(text)


def _timestamp(m: "re.Match[str]") -> Any:
    year, month, day = int(m["year"]), int(m["month"]), int(m["day"])
    if "hour" not in m.groupdict():
        return datetime.date(year, month, day)
    fraction = 0
    if m["fraction"]:
        fraction = int(m["fraction"][:6].ljust(6, "0"))
    tz = None
    if m["tz_sign"]:
        delta = datetime.timedelta(hours=int(m["tz_hour"]),
                                   minutes=int(m["tz_minute"] or 0))
        tz = datetime.timezone(-delta if m["tz_sign"] == "-" else delta)
    elif m["tz"]:
        tz = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(m["hour"]), int(m["minute"]),
                             int(m["second"]), fraction, tzinfo=tz)


def resolve_plain(text: str) -> Any:
    """The value of a plain (unquoted) scalar."""
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    m = _DATE.match(text) or _TIMESTAMP.match(text)
    if m:
        return _timestamp(m)
    return text


_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX = {"x": 2, "u": 4, "U": 8}


class _Reader:
    """One document: a list of (line number, indent, content) lines with
    comments and blank lines dropped."""

    def __init__(self, text: str, name: str):
        self.name = name
        self.lines: List[Tuple[int, int, str]] = []
        for number, raw in enumerate(text.splitlines(), 1):
            if "\t" in raw[: len(raw) - len(raw.lstrip())]:
                self.fail(number, "tab in indentation")
            content = _strip_comment(raw)
            if not content.strip():
                continue
            stripped = content.lstrip(" ")
            if number == 1 and stripped.startswith("%"):
                self.fail(number, "directives are not supported")
            if stripped.rstrip() in ("---", "...") or stripped.startswith("--- "):
                self.fail(number, "document markers are not supported")
            self.lines.append((number, len(content) - len(stripped), stripped.rstrip()))
        self.pos = 0

    def fail(self, number: int, msg: str):
        raise YAMLError(f"{self.name}:{number}: {msg}")

    def peek(self) -> Optional[Tuple[int, int, str]]:
        return self.lines[self.pos] if self.pos < len(self.lines) else None

    # -- block structure ---------------------------------------------------
    def document(self) -> Any:
        if not self.lines:
            return None
        value = self.node(self.lines[0][1])
        if self.peek() is not None:
            self.fail(self.peek()[0], "unexpected content after the document")
        return value

    def node(self, indent: int) -> Any:
        number, ind, text = self.peek()
        if ind != indent:
            self.fail(number, f"expected indentation {indent}, found {ind}")
        if text == "-" or text.startswith("- "):
            return self.sequence(indent)
        if _split_key(text, lambda m: self.fail(number, m)) is not None:
            return self.mapping(indent)
        self.pos += 1
        value = self.scalar(text, number)
        nxt = self.peek()
        if nxt is not None and nxt[1] > indent:
            self.fail(nxt[0], "multi-line scalars are not supported")
        return value

    def child(self, indent: int, seq_at_same: bool) -> Any:
        """The block under a key or dash whose own value was empty."""
        nxt = self.peek()
        if nxt is None:
            return None
        _, ind, text = nxt
        is_seq = text == "-" or text.startswith("- ")
        if ind > indent or (seq_at_same and ind == indent and is_seq):
            return self.node(ind)
        return None

    def sequence(self, indent: int) -> list:
        out = []
        while True:
            line = self.peek()
            if line is None or line[1] < indent:
                return out
            number, ind, text = line
            if ind > indent:
                self.fail(number, f"unexpected indentation {ind}")
            if not (text == "-" or text.startswith("- ")):
                return out
            rest = text[1:].lstrip(" ")
            if not rest:
                self.pos += 1
                out.append(self.child(indent, False))
                continue
            inner = indent + (len(text) - len(rest))
            if rest.startswith("- ") or rest == "-" or _split_key(
                    rest, lambda m: self.fail(number, m)) is not None:
                # "- key: value" or "- - x": a block opens on the dash's line
                self.lines[self.pos] = (number, inner, rest)
                out.append(self.node(inner))
                continue
            self.pos += 1
            out.append(self.scalar(rest, number))
            nxt = self.peek()
            if nxt is not None and nxt[1] > indent:
                self.fail(nxt[0], "multi-line scalars are not supported")

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while True:
            line = self.peek()
            if line is None or line[1] < indent:
                return out
            number, ind, text = line
            if ind > indent:
                self.fail(number, f"unexpected indentation {ind}")
            split = _split_key(text, lambda m: self.fail(number, m))
            if split is None:
                if text == "-" or text.startswith("- "):
                    return out
                self.fail(number, "expected 'key: value'")
            key_text, rest = split
            key = self.scalar(key_text, number)
            if isinstance(key, (dict, list)):
                self.fail(number, "complex keys are not supported")
            self.pos += 1
            if rest:
                out[key] = self.scalar(rest, number)
                nxt = self.peek()
                if nxt is not None and nxt[1] > indent:
                    self.fail(nxt[0], "multi-line scalars are not supported")
            else:
                out[key] = self.child(indent, True)

    # -- scalars and flow collections --------------------------------------
    def scalar(self, text: str, number: int) -> Any:
        if text[0] in "&*!|>%@`?":
            self.fail(number, f"'{text[0]}' (anchors, aliases, tags, block "
                              "scalars, reserved indicators) is not supported")
        if text[0] in "[{'\"":
            value, end = self.flow(text, 0, number, flow=False)
            if text[end:].strip():
                self.fail(number, f"unexpected text after a value: {text[end:]!r}")
            return value
        if text.startswith("- ") or ": " in text or text.endswith(":"):
            self.fail(number, "a block sequence or mapping cannot start here")
        return resolve_plain(text)

    def flow(self, text: str, i: int, number: int, flow: bool) -> Tuple[Any, int]:
        """The value starting at text[i] and the index just past it."""
        c = text[i]
        if c == "[":
            out, i = [], _skip(text, i + 1)
            if i < len(text) and text[i] == "]":
                return out, i + 1
            while True:
                value, i = self.flow(text, _skip(text, i), number, True)
                out.append(value)
                i = _skip(text, i)
                if i >= len(text):
                    self.fail(number, "unterminated flow sequence")
                if text[i] == "]":
                    return out, i + 1
                if text[i] != ",":
                    self.fail(number, f"expected ',' or ']' at column {i + 1}")
                i = _skip(text, i + 1)
                if i < len(text) and text[i] == "]":
                    return out, i + 1
        if c == "{":
            out, i = {}, _skip(text, i + 1)
            if i < len(text) and text[i] == "}":
                return out, i + 1
            while True:
                key, i = self.flow(text, _skip(text, i), number, True)
                i = _skip(text, i)
                if i >= len(text) or text[i] != ":":
                    self.fail(number, "flow mapping entries need 'key: value'")
                value, i = self.flow(text, _skip(text, i + 1), number, True)
                if isinstance(key, (dict, list)):
                    self.fail(number, "complex keys are not supported")
                out[key] = value
                i = _skip(text, i)
                if i >= len(text):
                    self.fail(number, "unterminated flow mapping")
                if text[i] == "}":
                    return out, i + 1
                if text[i] != ",":
                    self.fail(number, f"expected ',' or '}}' at column {i + 1}")
                i = _skip(text, i + 1)
        if c == "'":
            buf, i = [], i + 1
            while True:
                j = text.find("'", i)
                if j < 0:
                    self.fail(number, "unterminated single-quoted scalar")
                buf.append(text[i:j])
                if text[j + 1: j + 2] == "'":
                    buf.append("'")
                    i = j + 2
                    continue
                return "".join(buf), j + 1
        if c == '"':
            buf, i = [], i + 1
            while i < len(text):
                ch = text[i]
                if ch == '"':
                    return "".join(buf), i + 1
                if ch == "\\":
                    esc = text[i + 1: i + 2]
                    if esc in _ESCAPES:
                        buf.append(_ESCAPES[esc])
                        i += 2
                    elif esc in _HEX:
                        digits = text[i + 2: i + 2 + _HEX[esc]]
                        if not re.fullmatch(r"[0-9a-fA-F]+", digits or "x") or \
                                len(digits) != _HEX[esc]:
                            self.fail(number, f"bad escape \\{esc}{digits}")
                        buf.append(chr(int(digits, 16)))
                        i += 2 + _HEX[esc]
                    else:
                        self.fail(number, f"unknown escape \\{esc}")
                    continue
                buf.append(ch)
                i += 1
            self.fail(number, "unterminated double-quoted scalar")
        if c in "&*!|>%@`":
            self.fail(number, f"'{c}' is not supported")
        # a plain scalar inside a flow collection ends at , ] } or ': '
        j = i
        while j < len(text):
            ch = text[j]
            if flow and ch in ",]}":
                break
            if ch == ":" and (j + 1 == len(text) or text[j + 1] in " ,]}"):
                break
            j += 1
        plain = text[i:j].rstrip()
        if not plain:
            self.fail(number, f"empty value at column {i + 1}")
        return resolve_plain(plain), j


def _skip(text: str, i: int) -> int:
    while i < len(text) and text[i] == " ":
        i += 1
    return i


def _strip_comment(line: str) -> str:
    """The line without its comment: a '#' at the start or after a space,
    outside quotes."""
    quote, i = None, 0
    while i < len(line):
        ch = line[i]
        if quote == '"' and ch == "\\":
            i += 2
            continue
        if quote:
            if ch == quote:
                if quote == "'" and line[i + 1: i + 2] == "'":
                    i += 2
                    continue
                quote = None
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        i += 1
    return line


def _split_key(text: str, fail) -> Optional[Tuple[str, str]]:
    """(key, rest) of a ``key: value`` line, or None when the line is not
    a mapping entry."""
    if text[0] in "'\"":
        q = text[0]
        i = 1
        while True:
            j = text.find(q, i)
            if j < 0:
                return None
            if q == "'" and text[j + 1: j + 2] == "'":
                i = j + 2
                continue
            if q == '"' and text[j - 1] == "\\":
                i = j + 1
                continue
            break
        after = text[j + 1:].lstrip(" ")
        if after == ":" or after.startswith(": "):
            return text[: j + 1], after[1:].strip()
        return None
    if text[0] in "[{":
        return None
    if text.startswith("? "):
        fail("complex keys are not supported")
    i = 0
    while True:
        i = text.find(":", i)
        if i < 0:
            return None
        if i + 1 == len(text) or text[i + 1] == " ":
            return text[:i].rstrip(), text[i + 1:].strip()
        i += 1


def loads(text: str, name: str = "<string>") -> Any:
    """The value of a YAML document in the supported subset."""
    return _Reader(text, name).document()


def load(path) -> Any:
    with open(path) as f:
        return loads(f.read(), str(path))


# ---------------------------------------------------------------------------
# Writer

_INDICATORS = set("-?:,[]{}#&*!|>'\"%@`")


def _plain_ok(s: str) -> bool:
    if not s or s != s.strip() or s[0] in _INDICATORS or s in ("=", "<<"):
        return False
    if ": " in s or " #" in s or s.endswith(":") or "\n" in s:
        return False
    if any(ord(ch) < 32 or ord(ch) == 127 for ch in s):
        return False
    return resolve_plain(s) == s and isinstance(resolve_plain(s), str)


def _scalar(value: Any) -> str:
    if value is None:
        return "null"
    if value is True:
        return "true"
    if value is False:
        return "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:  # PyYAML's own float form
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, (datetime.date, datetime.datetime)):
        return value.isoformat()
    if isinstance(value, str):
        if _plain_ok(value):
            return value
        if any(ord(ch) < 32 or ord(ch) == 127 for ch in value):
            return json.dumps(value)
        return "'" + value.replace("'", "''") + "'"
    raise YAMLError(f"cannot write a {type(value).__name__} as YAML")


def _emit(value: Any, indent: int, out: List[str]) -> None:
    pad = " " * indent
    if isinstance(value, dict):
        for key, item in value.items():
            head = f"{pad}{_scalar(key)}:"
            if isinstance(item, (dict, list)) and item:
                out.append(head)
                _emit(item, indent + 2, out)
            else:
                out.append(f"{head} {_flow_empty(item)}")
        return
    for item in value:
        if isinstance(item, (dict, list)) and item:
            sub: List[str] = []
            _emit(item, indent + 2, sub)
            out.append(f"{pad}- {sub[0][indent + 2:]}")
            out.extend(sub[1:])
        else:
            out.append(f"{pad}- {_flow_empty(item)}")


def _flow_empty(value: Any) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, list):
        return "[]"
    return _scalar(value)


def dumps(value: Any) -> str:
    """Block YAML for nested dicts, lists and scalars (keys in order)."""
    if isinstance(value, tuple):
        value = list(value)
    if isinstance(value, (dict, list)) and value:
        out: List[str] = []
        _emit(_lists(value), 0, out)
        return "\n".join(out) + "\n"
    return _flow_empty(value) + "\n"


def _lists(value: Any) -> Any:
    if isinstance(value, dict):
        return {k: _lists(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_lists(v) for v in value]
    return value
