"""A YAML reader and writer with no dependencies, for the subset that the
configuration tree (``config/conf``) and the command-line overrides use.
The card host has no PyYAML; the JAX package reads the same files with
``yaml.safe_load``, so every scalar is typed as PyYAML's YAML 1.1 resolver
types it: its bool, int, float and null patterns are copied below. So
``1e-6`` (no dot) is a string and ``1.0e-6`` a float; ``on``/``off`` and
``yes``/``no`` are booleans.

The subset:

* block mappings, and block sequences of scalars or of mappings
  (``- name: x`` with more keys under it); a sequence may sit at its key's
  indentation;
* ``[a, b]`` flow sequences on one line, ``[]`` and ``{}``;
* ``#`` comments, also a key whose value holds only comments (null);
* plain scalars, ``"double-quoted"`` ones without escapes (``""`` is the
  empty string), ``${a.b}`` strings.

Anything else (single quotes, backslash escapes, anchors, aliases, tags,
block scalars, flow mappings with content, multi-line scalars, several
documents, timestamps, merge keys) raises ``ValueError`` naming its line.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

# PyYAML's implicit resolvers (yaml/resolver.py, YAML 1.1), verbatim
_BOOL_RE = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT_RE = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT_RE = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP_RE = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)

# characters that start a node outside the subset
_UNSUPPORTED_START = set("'&*!|>%@`?")


def _sexagesimal(value: str, cast):
    total, base = cast(0), 1
    for part in reversed(value.split(":")):
        total += cast(part) * base
        base *= 60
    return total


def _construct_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def _construct_int(value: str) -> int:
    value = value.replace("_", "")
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
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def resolve_plain(text: str, line: int = 0) -> Any:
    """A plain (unquoted) scalar typed as PyYAML's resolver types it, in its
    order: bool, float, int, null, else a string."""
    if _BOOL_RE.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT_RE.match(text):
        return _construct_float(text)
    if _INT_RE.match(text):
        return _construct_int(text)
    if _NULL_RE.match(text):
        return None
    if text in ("<<", "=") or _TIMESTAMP_RE.match(text):
        raise ValueError(f"line {line}: {text!r} is outside the YAML subset (merge key, value key or timestamp)")
    return text


class _Empty:
    """The value of ``key:`` with nothing after it on its line."""


_EMPTY = _Empty()


def _rest_is_comment(rest: str, line: int) -> None:
    rest = rest.strip()
    if rest and not rest.startswith("#"):
        raise ValueError(f"line {line}: unexpected text after a closed node: {rest!r}")


def _double_quoted(text: str, pos: int, line: int) -> Tuple[str, int]:
    """``text[pos]`` is '"' → (the string, the index after its closing quote)."""
    end = text.find('"', pos + 1)
    if end < 0:
        raise ValueError(f"line {line}: unclosed double-quoted scalar (multi-line scalars are outside the subset)")
    value = text[pos + 1:end]
    if "\\" in value:
        raise ValueError(f"line {line}: backslash escapes are outside the YAML subset")
    return value, end + 1


def _flow_sequence(text: str, pos: int, line: int) -> Tuple[list, int]:
    """``text[pos]`` is '[' → (the list, the index after its ']')."""
    out: list = []
    i = pos + 1
    expect_item = True
    while True:
        while i < len(text) and text[i] == " ":
            i += 1
        if i >= len(text):
            raise ValueError(f"line {line}: unclosed flow sequence (flow nodes must close on their line)")
        c = text[i]
        if c == "]":
            return out, i + 1
        if c == ",":
            if expect_item:
                raise ValueError(f"line {line}: empty item in a flow sequence")
            expect_item = True
            i += 1
            continue
        if not expect_item:
            raise ValueError(f"line {line}: expected ',' or ']' in a flow sequence")
        if c == '"':
            item, i = _double_quoted(text, i, line)
        elif c == "[":
            item, i = _flow_sequence(text, i, line)
        elif c == "{" or c in _UNSUPPORTED_START or c == "#":
            raise ValueError(f"line {line}: {c!r} inside a flow sequence is outside the YAML subset")
        else:
            j = i
            while j < len(text) and text[j] not in ",[]{}" and text[j:j + 2] not in (": ", " #"):
                j += 1
            if text[j:j + 2] == ": " or text[j:j + 2] == " #" or (j < len(text) and text[j] in "[{}"):
                raise ValueError(f"line {line}: mappings, comments and brackets inside a flow sequence are "
                                 "outside the YAML subset")
            item = resolve_plain(text[i:j].strip(), line)
            i = j
        out.append(item)
        expect_item = False


def _inline(text: str, line: int) -> Any:
    """The value written on one line after ``key:`` or ``- ``; ``_EMPTY`` when
    nothing but a comment follows."""
    text = text.strip()
    if not text or text.startswith("#"):
        return _EMPTY
    c = text[0]
    if c == '"':
        value, end = _double_quoted(text, 0, line)
        _rest_is_comment(text[end:], line)
        return value
    if c == "[":
        value, end = _flow_sequence(text, 0, line)
        _rest_is_comment(text[end:], line)
        return value
    if c == "{":
        if text[1:].lstrip().startswith("}"):
            _rest_is_comment(text[1:].lstrip()[1:], line)
            return {}
        raise ValueError(f"line {line}: flow mappings with content are outside the YAML subset")
    if c in _UNSUPPORTED_START or text.startswith("- ") or text == "-":
        raise ValueError(f"line {line}: {text!r} is outside the YAML subset (single quote, anchor, alias, tag, "
                         "block scalar, directive or compact nested sequence)")
    cut = text.find(" #")
    if cut >= 0:
        text = text[:cut].rstrip()
    if ": " in text or text.endswith(":"):
        raise ValueError(f"line {line}: a mapping is not allowed here: {text!r}")
    return resolve_plain(text, line)


def _key_split(text: str, line: int):
    """``key: rest`` → (key, rest); None when ``text`` is not a mapping entry."""
    if text[0] == '"':
        key, end = _double_quoted(text, 0, line)
        rest = text[end:].lstrip(" ")
        if rest == ":" or rest.startswith(": "):
            return key, rest[1:]
        return None
    for i, c in enumerate(text):
        if c == "#" and i > 0 and text[i - 1] == " ":
            return None
        if c == ":" and (i + 1 == len(text) or text[i + 1] == " "):
            key = text[:i].rstrip()
            if not key or key[0] in "[{,]}" or key[0] in _UNSUPPORTED_START:
                raise ValueError(f"line {line}: key {key!r} is outside the YAML subset")
            return resolve_plain(key, line), text[i + 1:]
    return None


def _is_entry(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Parser:
    def __init__(self, text: str):
        self.lines: List[Tuple[int, int, str]] = []  # (line number, indentation, content)
        for n, raw in enumerate(text.splitlines(), 1):
            content = raw.lstrip(" ")
            if content.startswith("\t") and content.strip():
                raise ValueError(f"line {n}: tabs in indentation are not YAML")
            if not content.strip() or content.startswith("#"):
                continue
            if raw.startswith(("---", "...", "%")):
                raise ValueError(f"line {n}: document markers and directives are outside the YAML subset")
            self.lines.append((n, len(raw) - len(content), content.rstrip()))

    def parse(self) -> Any:
        if not self.lines:
            return None
        value, i = self._node(0, self.lines[0][1])
        if i != len(self.lines):
            raise ValueError(f"line {self.lines[i][0]}: unexpected indentation")
        return value

    def _node(self, i: int, indent: int) -> Tuple[Any, int]:
        n, _, text = self.lines[i]
        if _is_entry(text):
            return self._sequence(i, indent)
        if _key_split(text, n) is not None:
            return self._mapping(i, indent)
        value = _inline(text, n)
        return value, i + 1

    def _value_after(self, i: int, indent: int, same_indent_list: bool) -> Tuple[Any, int]:
        """The block under line ``i`` (a key or an entry with nothing after
        it): deeper lines, or (for a key) a sequence at the key's own
        indentation; None when neither follows."""
        if i + 1 < len(self.lines):
            _, nxt, text = self.lines[i + 1]
            if nxt > indent or (same_indent_list and nxt == indent and _is_entry(text)):
                return self._node(i + 1, nxt)
        return None, i + 1

    def _mapping(self, i: int, indent: int) -> Tuple[dict, int]:
        out: dict = {}
        while i < len(self.lines):
            n, ind, text = self.lines[i]
            if ind < indent:
                break
            if ind > indent:
                raise ValueError(f"line {n}: unexpected indentation")
            split = _key_split(text, n)
            if split is None:
                if _is_entry(text):
                    break  # a sequence at its key's indentation ends here
                raise ValueError(f"line {n}: expected 'key: value', got {text!r}")
            key, rest = split
            value = _inline(rest, n)
            if value is _EMPTY:
                value, i = self._value_after(i, indent, same_indent_list=True)
            else:
                i += 1
            out[key] = value
        return out, i

    def _sequence(self, i: int, indent: int) -> Tuple[list, int]:
        out: list = []
        while i < len(self.lines):
            n, ind, text = self.lines[i]
            if ind < indent:
                break
            if ind > indent:
                raise ValueError(f"line {n}: unexpected indentation")
            if not _is_entry(text):
                break
            content = text[1:].lstrip(" ")
            if not content or content.startswith("#"):
                value, i = self._value_after(i, indent, same_indent_list=False)
            elif _key_split(content, n) is not None:
                # a mapping whose first key sits on the entry's line
                col = ind + len(text) - len(content)
                self.lines[i] = (n, col, content)
                value, i = self._mapping(i, col)
            else:
                value = _inline(content, n)
                i += 1
            out.append(value)
        return out, i


def load(text: str) -> Any:
    """Parse a YAML document of the subset (``yaml.safe_load``'s result)."""
    return _Parser(text).parse()


# -- writer -------------------------------------------------------------------

_PLAIN_OK = re.compile(r"^[A-Za-z0-9_./$~+(][A-Za-z0-9_./$~+(){}@= -]*$")


def _scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        # PyYAML's representer: a float must keep a dot to read back as one
        if value != value:
            return ".nan"
        if value in (math.inf, -math.inf):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str):
        if value and value == value.strip() and _PLAIN_OK.match(value):
            try:
                if resolve_plain(value) == value:
                    return value
            except ValueError:
                pass
        if '"' in value or "\\" in value or not value.isprintable():
            raise ValueError(f"{value!r} needs escapes, which are outside the YAML subset")
        return f'"{value}"'
    if hasattr(value, "item") and getattr(value, "shape", None) == ():
        return _scalar(value.item())  # a numpy scalar
    raise TypeError(f"cannot write {type(value).__name__} {value!r} as YAML")


def _emit(node: Any, indent: int, out: List[str]) -> None:
    pad = " " * indent
    if isinstance(node, dict):
        for k, v in node.items():
            if isinstance(v, (dict, list, tuple)) and len(v):
                out.append(f"{pad}{_scalar(k)}:")
                _emit(v, indent + 2, out)
            else:
                out.append(f"{pad}{_scalar(k)}: {_flat(v)}")
        return
    for item in node:
        if isinstance(item, (dict, list, tuple)) and len(item):
            sub: List[str] = []
            _emit(item, indent + 2, sub)
            if isinstance(item, dict):
                sub[0] = f"{pad}- {sub[0][indent + 2:]}"
                out.extend(sub)
            else:
                out.append(f"{pad}-")
                out.extend(sub)
        else:
            out.append(f"{pad}- {_flat(item)}")


def _flat(value: Any) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, (list, tuple)):
        return "[]"
    return _scalar(value)


def dump(data: Any) -> str:
    """``data`` (dicts, lists, tuples, str, int, float, bool, None) as YAML
    in block style; every string that would read back as another type is
    double-quoted. A string that would need an escape (a quote, a backslash,
    a control character) raises ``ValueError``. ``load(dump(x)) == x`` (tuples come back as lists), and
    so does ``yaml.safe_load``."""
    if isinstance(data, (dict, list, tuple)) and len(data):
        out: List[str] = []
        _emit(data, 0, out)
        return "\n".join(out) + "\n"
    return _flat(data) + "\n"
