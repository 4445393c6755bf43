"""ParmParse-style input-deck reader.

A copy of ``warpx_tpu.utils.parser`` (the port imports nothing of the JAX
package).  Reads the reference's flat-key input decks (``group.key = tokens``, ``#`` comments,
``my_constants`` usable in any numeric expression, quoted string tokens, CLI-style
``key=value`` overrides) so reference decks run unchanged.
Reference: amrex ParmParse decks + Source/Utils/Parser/ParserUtils.{H,cpp}
(parseStringtoReal resolves my_constants through the math parser) and the
unused-parameter check (Source/Evolve/WarpXEvolve.cpp:464-471).
"""

from __future__ import annotations

import re
import shlex
from pathlib import Path
from typing import Dict, List, Sequence

from .expression import evaluate_constant

__all__ = ["Deck"]


def _has_open_quote(line: str) -> bool:
    """True if a quoted token starts on this line but does not close
    (ParmParse quoted values may span physical lines)."""
    in_quote = None
    for ch in line:
        if in_quote:
            if ch == in_quote:
                in_quote = None
        elif ch in "\"'":
            in_quote = ch
        elif ch == "#":
            break
    return in_quote is not None


class Deck:
    """A parsed input deck: ordered multi-token values per flat key."""

    def __init__(self) -> None:
        self.table: Dict[str, List[str]] = {}
        self.my_constants: Dict[str, float] = {}
        self._queried: set[str] = set()
        self.base_dir: Path | None = None  # deck directory (relative paths)

    # ---------------------------------------------------------------- loading
    @classmethod
    def from_file(cls, path: str | Path, overrides: Sequence[str] = ()) -> "Deck":
        path = Path(path)
        text = path.read_text()
        return cls.from_string(text, overrides, base_dir=path.parent)

    @classmethod
    def from_string(
        cls,
        text: str,
        overrides: Sequence[str] = (),
        base_dir: Path | None = None,
    ) -> "Deck":
        deck = cls()
        deck.base_dir = base_dir
        logical_lines: List[str] = []
        cont = ""
        for raw in text.splitlines():
            line = cont + raw
            cont = ""
            if line.rstrip().endswith("\\"):
                cont = line.rstrip()[:-1] + " "
                continue
            if _has_open_quote(line):
                # ParmParse quoted values may span physical lines
                cont = line + " "
                continue
            logical_lines.append(line)
        if cont:
            logical_lines.append(cont)
        for line in logical_lines:
            deck._parse_line(line, base_dir=base_dir)
        for ov in overrides:
            deck._parse_line(ov)
        deck._resolve_my_constants()
        return deck

    def _parse_line(self, line: str, base_dir: Path | None = None) -> None:
        # strip comments: '#' outside quotes
        out = []
        in_quote = None
        for ch in line:
            if in_quote:
                out.append(ch)
                if ch == in_quote:
                    in_quote = None
                continue
            if ch in "\"'":
                in_quote = ch
                out.append(ch)
                continue
            if ch == "#":
                break
            out.append(ch)
        line = "".join(out).strip()
        if not line or "=" not in line:
            return
        key, _, value = line.partition("=")
        key = key.strip()
        if not key:
            return
        lex = shlex.shlex(value, posix=True)
        lex.whitespace_split = True
        lex.commenters = ""
        tokens = list(lex)
        if key == "FILE":
            # deck include (amrex ParmParse FILE directive), path relative to
            # the including deck; join continuation/open-quote lines the same
            # way from_string does (quoted values may span physical lines)
            inc = Path(tokens[0])
            if base_dir is not None and not inc.is_absolute():
                inc = base_dir / inc
            cont = ""
            for raw in inc.read_text().splitlines():
                line2 = cont + raw
                cont = ""
                if line2.rstrip().endswith("\\"):
                    cont = line2.rstrip()[:-1] + " "
                    continue
                if _has_open_quote(line2):
                    cont = line2 + " "
                    continue
                self._parse_line(line2, base_dir=inc.parent)
            if cont:
                self._parse_line(cont, base_dir=inc.parent)
            return
        self.table[key] = tokens

    def _resolve_my_constants(self) -> None:
        """Evaluate my_constants.* in order, allowing references to earlier ones."""
        pending = {
            k.split(".", 1)[1]: " ".join(str(t) for t in v)
            for k, v in self.table.items()
            if k.startswith("my_constants.")
        }
        # iterate: constants may reference each other in any order in principle,
        # but the reference resolves lazily; a few passes handle chains.
        for _ in range(len(pending) + 1):
            progressed = False
            for name, expr in list(pending.items()):
                if name in self.my_constants:
                    continue
                try:
                    self.my_constants[name] = evaluate_constant(
                        expr, self.my_constants
                    )
                    progressed = True
                except Exception:
                    continue
            if not progressed:
                break
        unresolved = set(pending) - set(self.my_constants)
        if unresolved:
            raise ValueError(f"Unresolvable my_constants: {sorted(unresolved)}")

    # ---------------------------------------------------------------- queries
    def contains(self, key: str) -> bool:
        return key in self.table

    def raw(self, key: str) -> List[str] | None:
        if key in self.table:
            self._queried.add(key)
            return self.table[key]
        return None

    def get_string(self, key: str, default: str | None = None) -> str | None:
        v = self.raw(key)
        return v[0] if v else default

    def get_strings(self, key: str, default: Sequence[str] = ()) -> List[str]:
        v = self.raw(key)
        return list(v) if v is not None else list(default)

    def get_real(self, key: str, default: float | None = None) -> float | None:
        v = self.raw(key)
        if v is None:
            return default
        return evaluate_constant(v[0], self.my_constants)

    def get_reals(self, key: str, default: Sequence[float] = ()) -> List[float]:
        v = self.raw(key)
        if v is None:
            return list(default)
        return [evaluate_constant(tok, self.my_constants) for tok in v]

    def get_int(self, key: str, default: int | None = None) -> int | None:
        r = self.get_real(key)
        if r is None:
            return default
        return int(round(r))

    def get_ints(self, key: str, default: Sequence[int] = ()) -> List[int]:
        v = self.raw(key)
        if v is None:
            return list(default)
        return [int(round(evaluate_constant(tok, self.my_constants))) for tok in v]

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.raw(key)
        if v is None:
            return default
        tok = v[0].lower()
        if tok in ("true", "t", "yes", "on"):
            return True
        if tok in ("false", "f", "no", "off"):
            return False
        return bool(int(round(float(evaluate_constant(tok, self.my_constants)))))

    def get_expr_string(self, prefix: str, base: str) -> tuple[str, list[str]] | None:
        """Find a parsed-function key like ``prefix.base(x,y,z)``.

        Returns (expression_string, [variable names]) or None.
        The reference stores such keys verbatim with the argument list in the key
        (e.g. electrons.momentum_function_ux(x,y,z), inputs_base_3d:66-68).
        """
        pattern = re.compile(re.escape(prefix) + r"\." + re.escape(base) + r"\(([^)]*)\)$")
        for key in self.table:
            m = pattern.match(key)
            if m:
                self._queried.add(key)
                variables = [v.strip() for v in m.group(1).split(",") if v.strip()]
                return " ".join(self.table[key]), variables
        # also accept without an argument list
        flat = f"{prefix}.{base}"
        if flat in self.table:
            self._queried.add(flat)
            return " ".join(self.table[flat]), ["x", "y", "z"]
        return None

    def unused_keys(self) -> List[str]:
        """Keys never queried — the reference warns about these after step 1."""
        return sorted(
            k
            for k in self.table
            if k not in self._queried and not k.startswith("my_constants.")
        )
