"""Role and function maps with SEED-style name normalization.

A copy of the reference package's ``genome/roles.py``.  Contract of the
reference tool's external ``RoleMap``/``Role``/``FunctionMap``/
``Function`` classes: role definition files (``roles.in.subsystems``) are
headerless 3-column TSV ``role_id<TAB>checksum<TAB>role_name``
(BuildKmerProcessor.java:122); role matching is normalization-based
(UpdateJsonProcessor.java:376); a feature function string is decomposed
into roles and matched against the map (Feature.getUsefulRoles,
BuildKmerProcessor.java:158).

Normalization follows the SEED conventions: strip EC/TC numbers, lowercase,
collapse whitespace.  Function strings split into roles on the SEED
separators `` / `` (fusion), `` @ `` (ambiguous multifunction) and ``; ``
(alternatives), with trailing comments (`` # ``/`` ! ``) removed.
"""

from __future__ import annotations

import hashlib
import re
from typing import Iterable

_EC_RE = re.compile(r"\s*\(\s*E\.?C\.?[\s:]+[0-9n.\-]+\s*\)")
_TC_RE = re.compile(r"\s*\(\s*T\.?C\.?[\s:]+[0-9A-Za-z.\-]+\s*\)")
_WS_RE = re.compile(r"\s+")
_COMMENT_RE = re.compile(r"\s+[#!]\s.*$")
_SPLIT_RE = re.compile(r"\s+/\s+|\s+@\s+|\s*;\s+")
_WORD_RE = re.compile(r"[A-Za-z0-9]+")

# Words skipped when generating magic IDs (SEED convention).
_LITTLE_WORDS = frozenset(
    "and or the a an of in on to with for by at from".split())


def normalize_role(text: str) -> str:
    """Normalized role text used for identity matching."""
    text = _EC_RE.sub("", text)
    text = _TC_RE.sub("", text)
    text = _WS_RE.sub(" ", text).strip()
    return text.lower()


def role_checksum(text: str) -> str:
    """MD5 checksum of the normalized role text."""
    return hashlib.md5(normalize_role(text).encode("utf-8")).hexdigest()


def split_function(function: str) -> list[str]:
    """Split a functional assignment into role strings (SEED separators)."""
    if not function:
        return []
    text = _COMMENT_RE.sub("", function).strip()
    if not text:
        return []
    return [r for r in (_SPLIT_RE.split(text)) if r]


def magic_id(name: str, taken: set[str]) -> str:
    """Generate a SEED-magic-style identifier from a name: up to 4-letter
    camel prefixes of the meaningful words, disambiguated with a number."""
    words = [w for w in _WORD_RE.findall(name) if w.lower() not in _LITTLE_WORDS]
    base = "".join(w[:4].capitalize() for w in words[:4]) or "Role"
    if base not in taken:
        return base
    n = 2
    while f"{base}{n}" in taken:
        n += 1
    return f"{base}{n}"


class Role:
    """A role definition: id plus (normalized) name."""

    def __init__(self, role_id: str, name: str):
        self.id = role_id
        self.name = name
        self.normalized = normalize_role(name)

    def matches(self, text: str) -> bool:
        return self.normalized == normalize_role(text)

    def __repr__(self) -> str:
        return f"Role({self.id!r}, {self.name!r})"


class RoleMap:
    """Map of role IDs to roles, indexed by normalized name for matching."""

    def __init__(self) -> None:
        self._by_id: dict[str, Role] = {}
        self._by_norm: dict[str, Role] = {}

    @classmethod
    def load(cls, path: str) -> "RoleMap":
        """Load a ``roles.in.subsystems``-format file: headerless TSV with
        role id in column 1 and role name in column 3 (column 2, the
        checksum, is recomputed from the name)."""
        rm = cls()
        with open(path, "r") as fh:
            for line in fh:
                line = line.rstrip("\n")
                if not line:
                    continue
                parts = line.split("\t")
                role_id = parts[0]
                name = parts[2] if len(parts) > 2 else parts[-1]
                rm.put(Role(role_id, name))
        return rm

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            for role in self._by_id.values():
                fh.write(f"{role.id}\t{role_checksum(role.name)}\t{role.name}\n")

    def put(self, role: Role) -> None:
        self._by_id[role.id] = role
        # First definition of a normalized name wins (synonym files list the
        # primary name first).
        self._by_norm.setdefault(role.normalized, role)

    def get(self, role_id: str) -> Role | None:
        return self._by_id.get(role_id)

    def get_name(self, role_id: str) -> str:
        role = self._by_id.get(role_id)
        return role.name if role else ""

    def by_name(self, text: str) -> Role | None:
        return self._by_norm.get(normalize_role(text))

    def contains_name(self, text: str) -> bool:
        return normalize_role(text) in self._by_norm

    def useful_roles(self, function: str) -> list[Role]:
        """Roles of a function string present in this map
        (Feature.getUsefulRoles contract)."""
        out = []
        for part in split_function(function):
            role = self.by_name(part)
            if role is not None:
                out.append(role)
        return out

    def __len__(self) -> int:
        return len(self._by_id)

    def __contains__(self, role_id: str) -> bool:
        return role_id in self._by_id

    def ids(self) -> Iterable[str]:
        return self._by_id.keys()


class Function:
    """An interned functional assignment (FunctionMap contract)."""

    def __init__(self, fun_id: str, name: str):
        self.id = fun_id
        self.name = name
        self.normalized = normalize_role(name)


class FunctionMap:
    """Interning map of function strings (CompareFunctions.java:73-76)."""

    def __init__(self) -> None:
        self._by_norm: dict[str, Function] = {}
        self._by_id: dict[str, Function] = {}
        self._ids: set[str] = set()

    def find_or_insert(self, name: str) -> Function:
        norm = normalize_role(name)
        fun = self._by_norm.get(norm)
        if fun is None:
            fun = Function(magic_id(name, self._ids), name)
            self._ids.add(fun.id)
            self._by_norm[norm] = fun
            self._by_id[fun.id] = fun
        return fun

    def get_by_name(self, name: str) -> Function | None:
        return self._by_norm.get(normalize_role(name))

    def get_by_id(self, fun_id: str) -> Function | None:
        return self._by_id.get(fun_id)

    def get_name(self, fun_id: str) -> str:
        fun = self._by_id.get(fun_id)
        return fun.name if fun else ""

    def __len__(self) -> int:
        return len(self._by_norm)
