"""Subsystem rule projection (SubsystemRuleProjector contract).

A copy of the reference package's ``genome/subsystems.py``.

The reference calls ``SubsystemRuleProjector.load(file)`` and
``projector.project(genome, true)`` (FunctionApplyProcessor.java:91, 174)
from the unmounted ``org.theseed.subsystems.core`` library; the projector
decides, from the roles present in a genome's functional assignments, which
subsystems are implemented and writes the matching subsystem rows (with
role → feature bindings) into the GTO.  Since the serialized form lives in
the unmounted jar, this module defines the file format natively:

    SUBSYSTEM <tab> name
    CLASS     <tab> superclass [<tab> class [<tab> subclass]]   (optional)
    ROLE      <tab> abbr <tab> role name                        (1+ lines)
    RULE      <tab> variant_code <tab> expression               (1+ lines)
    //                                                          (terminator)

Rule expressions are boolean formulas over the subsystem's role
abbreviations::

    AmtB and (GlnK or GlnB)
    2 of (RoleA, RoleB, RoleC)      # at least 2 present
    RoleA and not RoleD

Role presence is decided with the reference's synonym normalization
(``Role.matches`` — UpdateJsonProcessor.java:371-384 shows projector
matching is normalization-based): a role is present when any feature's
function contains a role whose normalized text equals the rule role's.
Rules are evaluated in file order; the first match sets the variant code.
Variant codes ``0``, ``-1``, ``inactive`` etc. mark missing/incomplete
variants (SubsystemRow.is_active convention); ``project(genome,
active_only=True)`` skips them.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass, field

from .gto import Genome
from .roles import normalize_role

log = logging.getLogger(__name__)

_INACTIVE_CODES = frozenset(("", "0", "-1", "inactive", "dirty.-1", "*-1"))

_TOKEN_RE = re.compile(r"\(|\)|,|[^\s(),]+")


# ---------------------------------------------------------------------------
# rule expressions
# ---------------------------------------------------------------------------

class RuleError(ValueError):
    """Malformed projector file or rule expression."""


class _Parser:
    """Recursive-descent parser for rule expressions.

    grammar:  expr   := term ('or' term)*
              term   := factor ('and' factor)*
              factor := 'not' factor | INT 'of' '(' expr (',' expr)* ')'
                        | '(' expr ')' | ABBR
    Produces a closure ``eval(present: set[str]) -> bool`` over the set of
    present role abbreviations.
    """

    def __init__(self, text: str, abbrs: set[str]):
        self.tokens = _TOKEN_RE.findall(text)
        self.pos = 0
        self.abbrs = abbrs
        self.text = text

    def peek(self) -> str | None:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def take(self) -> str:
        tok = self.peek()
        if tok is None:
            raise RuleError(f"unexpected end of rule {self.text!r}")
        self.pos += 1
        return tok

    def parse(self):
        fn = self.expr()
        if self.peek() is not None:
            raise RuleError(
                f"trailing {self.peek()!r} in rule {self.text!r}")
        return fn

    def expr(self):
        parts = [self.term()]
        while self.peek() and self.peek().lower() == "or":
            self.take()
            parts.append(self.term())
        if len(parts) == 1:
            return parts[0]
        return lambda p, parts=parts: any(f(p) for f in parts)

    def term(self):
        parts = [self.factor()]
        while self.peek() and self.peek().lower() == "and":
            self.take()
            parts.append(self.factor())
        if len(parts) == 1:
            return parts[0]
        return lambda p, parts=parts: all(f(p) for f in parts)

    def factor(self):
        tok = self.take()
        low = tok.lower()
        if low == "not":
            fn = self.factor()
            return lambda p, fn=fn: not fn(p)
        if tok.isdigit() and self.peek() and self.peek().lower() == "of":
            n = int(tok)
            self.take()  # 'of'
            if self.take() != "(":
                raise RuleError(f"expected '(' after 'of' in {self.text!r}")
            parts = [self.expr()]
            while self.peek() == ",":
                self.take()
                parts.append(self.expr())
            if self.take() != ")":
                raise RuleError(f"unclosed 'of' list in {self.text!r}")
            return lambda p, n=n, parts=parts: \
                sum(1 for f in parts if f(p)) >= n
        if tok == "(":
            fn = self.expr()
            if self.take() != ")":
                raise RuleError(f"unclosed '(' in {self.text!r}")
            return fn
        if tok in (")", ","):
            raise RuleError(f"unexpected {tok!r} in rule {self.text!r}")
        if tok not in self.abbrs:
            raise RuleError(
                f"unknown role abbreviation {tok!r} in rule {self.text!r}")
        return lambda p, tok=tok: tok in p


# ---------------------------------------------------------------------------
# subsystem specs + projector
# ---------------------------------------------------------------------------

@dataclass
class SubsystemSpec:
    """One subsystem's roles, classification, and variant rules."""

    name: str
    classifications: list[str] = field(default_factory=list)
    roles: list[tuple[str, str]] = field(default_factory=list)  # (abbr, name)
    rules: list[tuple[str, str]] = field(default_factory=list)  # (code, text)
    _compiled: list = field(default_factory=list, repr=False)

    def compile(self) -> None:
        if not self.roles:
            raise RuleError(f"subsystem {self.name!r} declares no roles")
        if not self.rules:
            raise RuleError(f"subsystem {self.name!r} declares no rules")
        abbrs = {a for a, _ in self.roles}
        self._compiled = [(code, _Parser(text, abbrs).parse())
                          for code, text in self.rules]

    def variant_of(self, present: set[str]) -> str | None:
        """First matching rule's variant code, or None."""
        for code, fn in self._compiled:
            if fn(present):
                return code
        return None


class SubsystemRuleProjector:
    """Projects subsystems onto genomes from role-presence rules."""

    def __init__(self, specs: list[SubsystemSpec]):
        self.specs = specs
        # normalized role name -> [(spec_idx, abbr)]: one genome role can
        # satisfy the same role name in several subsystems
        self._role_index: dict[str, list[tuple[int, str]]] = {}
        for i, spec in enumerate(specs):
            spec.compile()
            for abbr, name in spec.roles:
                self._role_index.setdefault(
                    normalize_role(name), []).append((i, abbr))

    @classmethod
    def load(cls, path: str) -> "SubsystemRuleProjector":
        specs: list[SubsystemSpec] = []
        cur: SubsystemSpec | None = None
        with open(path, "r") as fh:
            for ln, line in enumerate(fh, 1):
                line = line.rstrip("\r\n")
                if not line or line.startswith("#"):
                    continue
                if line.strip() == "//":
                    cur = None
                    continue
                tag, _, rest = line.partition("\t")
                fields = rest.split("\t")
                tag = tag.upper()
                if tag == "SUBSYSTEM":
                    cur = SubsystemSpec(name=fields[0].strip())
                    specs.append(cur)
                    continue
                if cur is None:
                    raise RuleError(
                        f"{path}:{ln}: {tag} line outside a SUBSYSTEM block")
                if tag == "CLASS":
                    cur.classifications = [f.strip() for f in fields if f]
                elif tag == "ROLE":
                    if len(fields) < 2:
                        raise RuleError(
                            f"{path}:{ln}: ROLE needs abbr + name")
                    cur.roles.append((fields[0].strip(),
                                      fields[1].strip()))
                elif tag == "RULE":
                    if len(fields) < 2:
                        raise RuleError(
                            f"{path}:{ln}: RULE needs code + expression")
                    cur.rules.append((fields[0].strip(),
                                      "\t".join(fields[1:]).strip()))
                else:
                    raise RuleError(f"{path}:{ln}: unknown tag {tag!r}")
        projector = cls(specs)
        log.info("%d subsystem specs loaded from %s.", len(specs), path)
        return projector

    def project(self, genome: Genome, active_only: bool = True) -> int:
        """Replace the genome's subsystems with projected rows; returns the
        number of subsystems projected (FunctionApplyProcessor.java:174
        contract: called in place of clearSubsystems)."""
        # role presence from the genome's functional assignments
        present: dict[int, set[str]] = {}          # spec -> {abbr}
        bindings: dict[tuple[int, str], list[str]] = {}  # (spec, abbr)->fids
        for feat in genome.features:
            fn = feat.function
            if not fn:
                continue
            from .roles import split_function
            for part in split_function(fn):
                for i, abbr in self._role_index.get(
                        normalize_role(part), ()):
                    present.setdefault(i, set()).add(abbr)
                    bindings.setdefault((i, abbr), []).append(feat.id)
        rows = []
        for i, spec in enumerate(self.specs):
            got = present.get(i, set())
            code = spec.variant_of(got)
            if code is None:
                continue
            if active_only and code in _INACTIVE_CODES:
                continue
            rows.append({
                "name": spec.name,
                "classification": list(spec.classifications),
                "variant_code": code,
                "role_bindings": [
                    {"role_id": name,
                     "features": bindings.get((i, abbr), [])}
                    for abbr, name in spec.roles
                    if abbr in got],
            })
        genome.raw["subsystems"] = rows
        log.info("%d subsystems projected onto %s.", len(rows), genome)
        return len(rows)
