"""Unicode property classes for the standard library's `re`.

The JAX package's BPE pre-tokenizer compiles its presets with the
third-party `regex` module, which reads `\\p{L}`, `\\p{N}`, `\\p{P}`, `\\p{S}`,
`\\p{M}` and the letter subcategories natively. The port uses only the
standard library: `translate` rewrites each `\\p{X}` of a pattern as an
explicit character class built from `unicodedata.category` (inside a
bracket class it becomes that class's ranges; outside, a bracket class of
its own), so stdlib `re` compiles every preset of `bpe.PRE_REGEXES`
unchanged. `\\s` and `\\S` are rewritten too: `re`'s `\\s` also matches
U+001C..U+001F, which `regex` (the Unicode White_Space property) does not.

The classes are built once per process, on first use (well under a second:
one `unicodedata.category` call per code point). They follow Python's Unicode
database (15.0 for Python 3.12); code points assigned later are outside
every class.
"""

from __future__ import annotations

import re
import sys
import unicodedata
from functools import lru_cache

# property name → general categories (Unicode general category groups)
_GROUPS = {
    "L": ("Lu", "Ll", "Lt", "Lm", "Lo"),
    "M": ("Mn", "Mc", "Me"),
    "N": ("Nd", "Nl", "No"),
    "P": ("Pc", "Pd", "Ps", "Pe", "Pi", "Pf", "Po"),
    "S": ("Sm", "Sc", "Sk", "So"),
}
# the White_Space property: str.isspace() without the information separators
_NOT_WHITE_SPACE = frozenset("\x1c\x1d\x1e\x1f")


@lru_cache(maxsize=1)
def _runs_by_category() -> dict[str, list[tuple[int, int]]]:
    """General category → its runs of consecutive code points [lo, hi]."""
    cats = list(map(unicodedata.category, map(chr, range(sys.maxunicode + 1))))
    letter = {c: chr(65 + i) for i, c in enumerate(sorted(set(cats)))}
    coded = "".join(map(letter.__getitem__, cats))  # one letter per code point
    out: dict[str, list[tuple[int, int]]] = {}
    for m in re.finditer(r"(.)\1*", coded, re.S):
        out.setdefault(cats[m.start()], []).append((m.start(), m.end() - 1))
    return out


def _esc(cp: int) -> str:
    return f"\\u{cp:04x}" if cp <= 0xFFFF else f"\\U{cp:08x}"


def _body(runs: list[tuple[int, int]]) -> str:
    """Runs of code points → the body of a bracket class, as escaped ranges."""
    merged: list[list[int]] = []
    for lo, hi in sorted(runs):
        if merged and lo == merged[-1][1] + 1:
            merged[-1][1] = hi
        else:
            merged.append([lo, hi])
    return "".join(_esc(lo) if lo == hi else f"{_esc(lo)}-{_esc(hi)}" for lo, hi in merged)


@lru_cache(maxsize=None)
def class_body(name: str) -> str:
    """The bracket-class body of `\\p{name}` (a group letter or a general
    category), or of `\\s` for name "s"."""
    if name == "s":  # every white-space character lies below U+3001
        return _body([(cp, cp) for cp in range(0x3001)
                      if chr(cp).isspace() and chr(cp) not in _NOT_WHITE_SPACE])
    by_cat = _runs_by_category()
    cats = _GROUPS.get(name, (name,))
    if any(c not in by_cat for c in cats):
        raise ValueError(f"unknown Unicode property \\p{{{name}}}")
    return _body([r for c in cats for r in by_cat[c]])


def translate(expr: str) -> str:
    """A `regex`-module pattern → the same pattern for stdlib `re`."""
    out: list[str] = []
    in_class = False
    i = 0
    while i < len(expr):
        c = expr[i]
        if c == "\\":
            nxt = expr[i + 1]
            if nxt == "p" and expr[i + 2:i + 3] == "{":
                end = expr.index("}", i)
                body = class_body(expr[i + 3:end])
                out.append(body if in_class else f"[{body}]")
                i = end + 1
                continue
            if nxt == "s":
                out.append(class_body("s") if in_class else f"[{class_body('s')}]")
            elif nxt == "S":
                if in_class:
                    raise ValueError(f"\\S inside a bracket class: {expr!r}")
                out.append(f"[^{class_body('s')}]")
            else:
                out.append(expr[i:i + 2])
            i += 2
            continue
        out.append(c)
        i += 1
        if c == "[" and not in_class:
            in_class = True
            if expr[i:i + 1] == "^":
                out.append("^")
                i += 1
            if expr[i:i + 1] == "]":  # a ] first in a class is literal
                out.append("\\]")
                i += 1
        elif c == "]" and in_class:
            in_class = False
    return "".join(out)
