"""A strict reader for the YAML that okvis2.yaml- and se2.yaml-schema files use.

The JAX package reads its configs with PyYAML's ``safe_load``
(``okvis2x_tpu/io/config.py``); the port reads the same files without it.
What is read, with the values ``yaml.safe_load`` gives:

  * an optional ``%YAML:x.y`` line (OpenCV FileStorage's header) and one
    optional ``---`` before the content;
  * ``#`` comments (at a line's start or after a blank);
  * block mappings and block sequences by indentation, a sequence also at
    its mapping key's indentation, and ``- key: value`` items;
  * flow mappings and sequences, nested and spanning lines (okvis2.yaml's
    ``cameras: - {T_SC: [ ... ], ...}``);
  * plain scalars on one line, resolved as YAML 1.1 resolves them (null,
    booleans such as ``yes``/``off``, ints in decimal, octal, hex, binary
    and base 60, floats, ``.inf``/``.nan``), and single- or double-quoted
    strings on one line.

Anything else (anchors, aliases, tags, block scalars, several documents,
complex keys, timestamps, multi-line scalars, tabs in indentation) raises
``ValueError`` naming the line.
"""

from __future__ import annotations

import re

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9_]+(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
# characters a plain scalar may not start with
_INDICATORS = set("&*!|>%@`?")
_FLOW_END = set(",[]{}")


def _fail(line: int, msg: str):
    raise ValueError(f"line {line}: {msg}")


def _sexagesimal(value: str, cast):
    out, base = cast(0), 1
    for part in reversed(value.split(":")):
        out += cast(part) * base
        base *= 60
    return out


def resolve(text: str, line: int = 0):
    """A plain scalar's value, as PyYAML's safe loader resolves it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    if _TIMESTAMP.match(text):
        _fail(line, f"timestamps are not handled: {text!r}")
    if text in ("=", "<<"):
        _fail(line, f"the value/merge key {text!r} is not handled")
    return text


def _quoted_end(s: str, i: int, line: int) -> int:
    """Index after the quoted scalar that starts at s[i]."""
    q, j = s[i], i + 1
    while j < len(s):
        if s[j] == "\n":
            _fail(line, "quoted scalars spanning lines are not handled")
        if q == "'" and s[j] == "'":
            if s[j + 1:j + 2] == "'":
                j += 2
                continue
            return j + 1
        if q == '"' and s[j] == "\\":
            j += 2
            continue
        if q == '"' and s[j] == '"':
            return j + 1
        j += 1
    _fail(line, "unterminated quoted scalar")


def _unquote(tok: str, line: int) -> str:
    body = tok[1:-1]
    if tok[0] == "'":
        return body.replace("''", "'")
    out, j = [], 0
    while j < len(body):
        ch = body[j]
        if ch != "\\":
            out.append(ch)
            j += 1
            continue
        e = body[j + 1:j + 2]
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            j += 2
        elif e in _HEX_ESCAPES:
            n = _HEX_ESCAPES[e]
            code = body[j + 2:j + 2 + n]
            if len(code) != n or not all(c in "0123456789abcdefABCDEF" for c in code):
                _fail(line, f"bad escape \\{e}{code}")
            out.append(chr(int(code, 16)))
            j += 2 + n
        else:
            _fail(line, f"unknown escape \\{e}")
    return "".join(out)


def _opens_quote(s: str, i: int) -> bool:
    """Whether a quote at s[i] starts a quoted scalar: it follows the start,
    a flow indicator, or a blank after ':', '-' or '?'; else it sits in a
    plain scalar (``it's``)."""
    k = i - 1
    while k >= 0 and s[k] in " \n":
        k -= 1
    return k < 0 or s[k] in "[{," or (s[k] in ":-?" and k + 1 < i)


def _strip_comment(s: str, line: int) -> str:
    i = 0
    while i < len(s):
        ch = s[i]
        if ch in "'\"" and _opens_quote(s, i):
            i = _quoted_end(s, i, line)
            continue
        if ch == "#" and (i == 0 or s[i - 1] in " \t"):
            return s[:i].rstrip()
        i += 1
    return s.rstrip()


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no, indent, text):
        self.no, self.indent, self.text = no, indent, text


def _lines(text: str):
    out, started = [], False
    for no, raw in enumerate(text.splitlines(), 1):
        if raw.startswith("%"):
            if raw.startswith("%YAML") and not started:
                continue
            _fail(no, f"directive {raw!r} is not handled")
        body = raw.lstrip(" ")
        if body.startswith("\t") and body.strip():
            _fail(no, "tabs in indentation are not handled")
        stripped = _strip_comment(body, no)
        if not stripped:
            continue
        if raw.startswith("---") and raw[3:4] in ("", " ", "\t"):
            if started or stripped != "---":
                _fail(no, "several documents, or content after '---', are not handled")
            started = True
            continue
        if raw.startswith("...") and raw[3:4] in ("", " ", "\t"):
            _fail(no, "document end markers are not handled")
        started = True
        out.append(_Line(no, len(raw) - len(body), stripped))
    return out


class _Flow:
    """Recursive descent over one flow collection (it may span lines)."""

    def __init__(self, s: str, line: int):
        self.s, self.i, self.line0 = s, 0, line

    def _line(self):
        return self.line0 + self.s.count("\n", 0, self.i)

    def ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \n\t":
            self.i += 1

    def peek(self):
        return self.s[self.i:self.i + 1]

    def node(self, in_map_key=False):
        self.ws()
        ch = self.peek()
        if ch == "[":
            if in_map_key:
                _fail(self._line(), "complex mapping keys are not handled")
            return self.seq()
        if ch == "{":
            if in_map_key:
                _fail(self._line(), "complex mapping keys are not handled")
            return self.map()
        if ch in ("'", '"'):
            j = _quoted_end(self.s, self.i, self._line())
            tok, self.i = self.s[self.i:j], j
            return _unquote(tok, self._line())
        return self.plain()

    def plain(self):
        start, s = self.i, self.s
        if s[start:start + 1] in _INDICATORS or s[start:start + 2] in ("- ", "-\n"):
            _fail(self._line(), f"{s[start]!r} (anchor, alias, tag, block scalar or reserved "
                  "indicator) is not handled")
        j = start
        while j < len(s) and s[j] not in _FLOW_END:
            if s[j] == ":" and (j + 1 == len(s) or s[j + 1] in " \n,[]{}"):
                break
            j += 1
        tok = s[start:j].strip(" \t")
        if "\n" in tok:
            _fail(self._line(), "plain scalars spanning lines are not handled")
        self.i = j
        return resolve(tok, self._line())

    def seq(self):
        self.i += 1
        out = []
        while True:
            self.ws()
            if self.peek() == "]":
                self.i += 1
                return out
            if self.peek() == "":
                _fail(self.line0, "unterminated flow sequence")
            out.append(self.node())
            self.ws()
            if self.peek() == ":":
                _fail(self._line(), "single-pair mappings in flow sequences are not handled")
            self.sep("]")

    def map(self):
        self.i += 1
        out = {}
        while True:
            self.ws()
            if self.peek() == "}":
                self.i += 1
                return out
            if self.peek() == "":
                _fail(self.line0, "unterminated flow mapping")
            if self.peek() == "?":
                _fail(self._line(), "complex mapping keys are not handled")
            key = self.node(in_map_key=True)
            self.ws()
            value = None
            if self.peek() == ":":
                self.i += 1
                self.ws()
                if self.peek() not in (",", "}"):
                    value = self.node()
            out[key] = value
            self.sep("}")

    def sep(self, close):
        self.ws()
        ch = self.peek()
        if ch == ",":
            self.i += 1
        elif ch != close:
            _fail(self._line(), f"expected ',' or {close!r}, found {ch!r}")


def _flow_extent(lines, i: int, start: str) -> tuple:
    """Join `start` (the text from an opening bracket) with the following
    lines until the brackets balance; returns (text, index of the next line)."""
    parts, depth, k, s = [], 0, i, start
    while True:
        j = 0
        while j < len(s):
            ch = s[j]
            if ch in "'\"" and _opens_quote(s, j):
                j = _quoted_end(s, j, lines[k].no)
                continue
            if ch in "[{":
                depth += 1
            elif ch in "]}":
                depth -= 1
                if depth == 0:
                    if s[j + 1:].strip():
                        _fail(lines[k].no, f"content after a flow collection: {s[j + 1:]!r}")
                    parts.append(s[:j + 1])
                    return "\n".join(parts), k + 1
            j += 1
        parts.append(s)
        k += 1
        if k == len(lines):
            _fail(lines[i].no, "unterminated flow collection")
        s = lines[k].text


def _mapping_split(text: str, line: int):
    """(key text, value text) when `text` is a block mapping entry, else None."""
    j = 0
    depth = 0
    while j < len(text):
        ch = text[j]
        if ch in "'\"" and _opens_quote(text, j):
            j = _quoted_end(text, j, line)
            continue
        if ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == ":" and depth == 0 and (j + 1 == len(text) or text[j + 1] == " "):
            return text[:j].rstrip(), text[j + 1:].strip()
        j += 1
    return None


def _key(text: str, line: int):
    if not text:
        _fail(line, "empty mapping key")
    if text[0] in "[{":
        _fail(line, "complex mapping keys are not handled")
    if text[0] in ("'", '"'):
        if _quoted_end(text, 0, line) != len(text):
            _fail(line, f"bad quoted key {text!r}")
        return _unquote(text, line)
    if text[0] in _INDICATORS or text.startswith("- "):
        _fail(line, f"key {text!r}: anchors, tags, complex keys and reserved indicators "
              "are not handled")
    return resolve(text, line)


class _Block:
    def __init__(self, lines):
        self.lines = lines

    def inline(self, i: int, text: str):
        """The value written on line i after its indicator (scalar or flow
        collection); returns (value, index of the next line)."""
        no = self.lines[i].no
        if text[0] in "[{":
            s, nxt = _flow_extent(self.lines, i, text)
            return _Flow(s, no).node(), nxt
        if text[0] in ("'", '"'):
            if _quoted_end(text, 0, no) != len(text):
                _fail(no, f"content after a quoted scalar: {text!r}")
            return _unquote(text, no), i + 1
        if text[0] in _INDICATORS:
            _fail(no, f"{text[0]!r} (anchor, alias, tag, block scalar or reserved indicator) "
                  "is not handled")
        if text.startswith("- ") or text == "-":
            _fail(no, "block sequence entries are not allowed here")
        if _mapping_split(text, no) is not None:
            _fail(no, "mapping values are not allowed here")
        return resolve(text, no), i + 1

    def nested(self, i: int, indent: int, seq_ok: bool):
        """The block value that follows a bare indicator at `indent`."""
        if i < len(self.lines):
            ln = self.lines[i]
            if ln.indent > indent or (seq_ok and ln.indent == indent and _is_item(ln.text)):
                return self.node(i, ln.indent)
        return None, i

    def node(self, i: int, indent: int):
        ln = self.lines[i]
        if _is_item(ln.text):
            return self.seq(i, indent)
        if _mapping_split(ln.text, ln.no) is not None:
            return self.map(i, indent)
        return self.inline(i, ln.text)

    def seq(self, i: int, indent: int):
        out = []
        while (i < len(self.lines) and self.lines[i].indent == indent
               and _is_item(self.lines[i].text)):
            ln = self.lines[i]
            rest = ln.text[1:]
            body = rest.lstrip(" ")
            if not body:
                value, i = self.nested(i + 1, indent, seq_ok=False)
            elif _is_item(body) or _mapping_split(body, ln.no) is not None:
                # a sequence or mapping that starts on the item's line at
                # the column of its first entry
                col = indent + 1 + len(rest) - len(body)
                self.lines[i] = _Line(ln.no, col, body)
                value, i = (self.seq if _is_item(body) else self.map)(i, col)
            else:
                value, i = self.inline(i, body)
            out.append(value)
            self.check_dedent(i, indent)
        return out, i

    def map(self, i: int, indent: int):
        out = {}
        while i < len(self.lines) and self.lines[i].indent == indent:
            ln = self.lines[i]
            split = _mapping_split(ln.text, ln.no)
            if split is None:
                if _is_item(ln.text):
                    _fail(ln.no, "a block sequence entry where a mapping key was expected")
                _fail(ln.no, f"expected 'key: value', found {ln.text!r}")
            key = _key(split[0], ln.no)
            try:
                hash(key)
            except TypeError:
                _fail(ln.no, "unhashable mapping key")
            if split[1]:
                value, i = self.inline(i, split[1])
            else:
                value, i = self.nested(i + 1, indent, seq_ok=True)
            out[key] = value
            self.check_dedent(i, indent)
        return out, i

    def check_dedent(self, i: int, indent: int):
        if i < len(self.lines) and self.lines[i].indent > indent:
            _fail(self.lines[i].no, "unexpected indentation (multi-line plain scalars are "
                  "not handled)")


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def loads(text: str):
    """Parse one document of the subset described above."""
    lines = _lines(text)
    if not lines:
        return None
    b = _Block(lines)
    value, i = b.node(0, lines[0].indent)
    if i < len(lines):
        _fail(lines[i].no, "content after the document's root node")
    return value


def load(path: str):
    with open(path) as f:
        return loads(f.read())
