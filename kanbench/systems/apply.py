"""The apply cells: genomes' pegs called against a signature table through
``KmerApplyEngine``, driven as the ``apply`` command drives it:
``prefetch_map`` (its defaults) runs ``engine.prepare`` in worker threads
and ``engine.call_prepared`` runs on the main thread, in a closed loop over
the configuration's genomes, cycled.

The data, from the seed: the table and the genomes.  Each role has a
prototype and varied members (the prototype with a share of its residues
substituted, a member's own); the table holds the members' kmers, member
by member across the roles, first occurrence kept and kmers found in two
roles dropped (as ``build`` drops them), to the configured key count;
weights are fp16 values from a uniform range.  The genomes' peg counts and
protein lengths are a multiset fixed by the configuration (peg counts
spread evenly over their range, lengths the log-normal law's quantiles),
drawn into genomes in the seed's order.  A share of the proteins carry a
segment of one member, drawn over all members in the table, with
substitutions, a smaller share two; the rest are random.  So a genome's
hits fall all over the table, not on a few cached buckets.
"""

from __future__ import annotations

import time
from statistics import NormalDist

import numpy as np

from ..reference import apply as ref
from ..reference import codes as C

AA = np.frombuffer(C.AMINO_ACIDS.encode(), np.uint8)
CHECK_SHARE = 0.125        # the window's calls kept for the check, drawn


def _aa_letters(idx: np.ndarray) -> np.ndarray:
    """Amino-acid indices (0..19) as letter codes (A..Z = 0..25)."""
    return (AA[idx] - ord("A")).astype(np.uint8)


def _substitute(seqs: np.ndarray, rate: float, rng) -> np.ndarray:
    """Amino-acid indices with a share ``rate`` replaced by another."""
    out = seqs.copy()
    sub = rng.random(out.shape, np.float32) < rate
    out[sub] = (out[sub] + rng.integers(1, 20, int(sub.sum()),
                                        dtype=np.uint8)) % 20
    return out


def make_table(config: dict, rng) -> dict:
    """Keys (uint64), roles and weights of the signature table, and the
    members its keys came from (amino-acid indices, a row a member,
    those whose kmers made the table)."""
    k, n_keys, n_roles = config["k"], config["table_keys"], config["roles"]
    seg = config["prototype_residues"]
    n_win = seg - k + 1
    n_members = -(-n_keys * 5 // (4 * n_win * n_roles)) + 1
    protos = rng.integers(0, 20, (n_roles, seg), dtype=np.uint8)
    members = _substitute(np.broadcast_to(protos, (n_members, n_roles, seg)),
                          config["member_divergence"], rng)
    members = members.reshape(-1, seg)         # member-major: row m * R + r
    c = _aa_letters(members).astype(np.uint64)
    keys = np.zeros((len(members), n_win), np.uint64)
    for j in range(k):
        keys |= c[:, j: j + n_win] << np.uint64(C.BITS * j)
    keys = keys.reshape(-1)
    roles = np.repeat(np.arange(len(members)) % n_roles, n_win)
    # (key, role) pairs once each; a key with two roles is dropped
    pair = (keys << np.uint64(16)) | roles.astype(np.uint64)
    upair, first = np.unique(pair, return_index=True)
    ukey = upair >> np.uint64(16)
    lone = np.ones(len(ukey), bool)
    dup = ukey[1:] == ukey[:-1]
    lone[1:] &= ~dup
    lone[:-1] &= ~dup
    keep = np.sort(first[lone])[:n_keys]
    if len(keep) < n_keys:
        raise ValueError("the members gave too few distinct kmers")
    weights = rng.uniform(config["weight_low"], config["weight_high"],
                          n_keys).astype(np.float16).astype(np.float32)
    return dict(keys=keys[keep], roles=roles[keep].astype(np.int32),
                weights=weights, members=members[: keep[-1] // n_win + 1])


def make_genomes(config: dict, members, rng) -> dict:
    """The genomes: their proteins' letters (one array) and offsets."""
    n_genomes = config["pool_genomes"]
    pegs = np.rint(np.linspace(config["pegs_min"], config["pegs_max"],
                               n_genomes)).astype(np.int64)
    pegs = rng.permutation(pegs)
    total = int(pegs.sum())
    law = NormalDist(np.log(config["length_median"]), config["length_sigma"])
    q = np.array([law.inv_cdf((i + 0.5) / total) for i in range(total)])
    lengths = np.clip(np.rint(np.exp(q)), config["length_min"],
                      config["length_max"]).astype(np.int64)
    lengths = rng.permutation(lengths)
    seg = config["prototype_residues"]
    letters = rng.integers(0, 20, int(lengths.sum()), dtype=np.uint8)
    offsets = np.r_[0, np.cumsum(lengths)]
    # role carriers: a share of all proteins, among those a segment fits;
    # a smaller share carry two, among those two fit
    n_two = int(round(config["two_role_share"] * total))
    n_one = int(round(config["role_share"] * total)) - n_two
    two = rng.permutation(np.flatnonzero(lengths >= 2 * seg))[:n_two]
    rest = np.setdiff1d(np.flatnonzero(lengths >= seg), two)
    one = rng.permutation(rest)[:n_one]
    half = lengths[two] // 2
    starts = np.concatenate([
        offsets[one] + rng.integers(0, lengths[one] - seg + 1),
        offsets[two] + rng.integers(0, half - seg + 1),
        offsets[two] + half + rng.integers(0, lengths[two] - half - seg + 1)])
    which = rng.integers(0, len(members), len(starts))
    planted = _substitute(members[which], config["substitution_rate"], rng)
    letters[(starts[:, None] + np.arange(seg)).reshape(-1)] = \
        planted.reshape(-1)
    letters = _aa_letters(letters)
    bounds = np.r_[0, np.cumsum(pegs)]
    return dict(letters=letters, offsets=offsets, bounds=bounds,
                n_genomes=n_genomes)


def genome_raw(gid: str, proteins: list) -> dict:
    return {"id": gid, "scientific_name": "Synthetic", "genetic_code": 11,
            "domain": "Bacteria",
            "features": [{"id": f"fig|{gid}.peg.{i + 1}", "type": "CDS",
                          "function": "hypothetical protein",
                          "protein_translation": p}
                         for i, p in enumerate(proteins)],
            "contigs": [], "close_genomes": [], "subsystems": []}


class Cell:
    """One apply cell: set-up, the window, the check."""

    e2e = ("proteins_per_s", "genome_p95_ms", "peak_device_gib", "setup_s")

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from kmers_anno_tpu_torch.engine.apply_engine import KmerApplyEngine
        from kmers_anno_tpu_torch.engine.signature import SignatureTable
        from kmers_anno_tpu_torch.genome.gto import Genome
        from kmers_anno_tpu_torch.utils.prefetch import prefetch_map

        self.config, self.traffic, self.device = config, traffic, device
        self.weighted = bool(traffic["weighted"])
        self.prefetch_map = prefetch_map
        rng = np.random.default_rng(seed)
        self.table = make_table(config, rng)
        self.pool = make_genomes(config, self.table["members"], rng)
        text = (self.pool["letters"] + ord("A")).tobytes().decode()
        off, b = self.pool["offsets"], self.pool["bounds"]
        self.genomes = []
        for g in range(self.pool["n_genomes"]):
            prots = [text[off[i]: off[i + 1]] for i in range(b[g], b[g + 1])]
            self.genomes.append(Genome(genome_raw(f"{1000 + g}.1", prots)))
        lo, hi = C.split_key(self.table["keys"])
        self.role_ids = [f"Role{r}" for r in range(config["roles"])]
        sig = SignatureTable(
            k=config["k"], key_lo=lo, key_hi=hi,
            role_idx=self.table["roles"], role_ids=self.role_ids,
            weights=self.table["weights"] if self.weighted else None)
        self.engine = KmerApplyEngine(sig, min_hits=config["min_hits"],
                                      weighted=self.weighted, device=device)
        self.check_rng = np.random.default_rng([seed, 2])
        self.kept: list = []             # (pool index, calls) sampled
        self.latency: list = []
        self.failed = 0

    def route_counters(self) -> dict:
        """The program's launch counters of the apply steps."""
        from kmers_anno_tpu_torch.ops.apply_flat import (apply_flat,
                                                         apply_weighted_flat)
        from kmers_anno_tpu_torch.ops.apply_rows import apply_rows

        return {"apply_flat": apply_flat.launches,
                "apply_flat_weighted": apply_weighted_flat.launches,
                "apply_rows": apply_rows.launches}

    def facts(self) -> dict:
        """The table as the engine holds it."""
        return {"table_buckets": int(self.engine.table.shape[0]),
                "mode": self.engine.mode}

    def warm_up(self, sync) -> None:
        """Every pool genome once through prepare and call_prepared."""
        for g in self.genomes:
            self.engine.call_prepared(*self.engine.prepare(g))
        sync()

    def window(self, seconds: float, sync, clock=time.perf_counter) -> dict:
        n_pool = len(self.genomes)
        engine = self.engine

        def load(i):
            t = clock()
            return i, t, engine.prepare(self.genomes[i % n_pool])

        it = self.prefetch_map(range(1 << 20), load)
        proteins = 0
        t0 = clock()
        try:
            for i, t_in, prepared in it:
                calls = engine.call_prepared(*prepared)
                sync()
                t_out = clock()
                self.latency.append(t_out - t_in)
                proteins += len(prepared[0])
                if self.check_rng.random() < CHECK_SHARE or i == 0:
                    self.kept.append((i % n_pool, calls))
                if t_out - t0 >= seconds:
                    break
        finally:
            it.close()
        window_s = clock() - t0
        lat = sorted(self.latency)
        p95 = lat[min(len(lat) - 1, int(np.ceil(0.95 * len(lat))) - 1)]
        return dict(window_s=window_s, n_done=len(self.latency),
                    proteins_per_s=proteins / window_s,
                    genome_p95_ms=1e3 * p95)

    def free(self) -> None:
        """Drop the program's state, keeping what the window produced."""
        self.kept = [(g, {f.id: (role, hits) for f, role, hits in calls})
                     for g, calls in self.kept]
        self.engine = None
        self.genomes = None

    def check(self, limits: dict, control: bool = False) -> dict:
        """Every kept genome's calls against the reference's: pegs whose
        call differs; for the weighted vote, pegs whose role differs and
        the largest tally gap where the role agrees.  ``control`` puts the
        reference's control run in the program's place: lossy keys, or
        weighted sums in bfloat16."""
        import torch

        dev = self.device
        cfg = self.config
        t = self.table
        weights = t["weights"] if self.weighted else None
        want = self._reference(ref.Table(t["keys"], t["roles"], weights,
                                         device=dev))
        got_of = None
        if control:
            ctl = ref.Table(t["keys"], t["roles"], weights, device=dev,
                            lossy=not self.weighted)
            got_of = self._reference(
                ctl, torch.bfloat16 if self.weighted else torch.float64)
        n_bad = n_role = 0
        gap = 0.0
        self.failed = 0
        for g, calls in self.kept:
            bad_before = n_bad
            w_role, w_hits = want[g]
            ids = [f"fig|{1000 + g}.1.peg.{i + 1}"
                   for i in range(len(w_role))]
            if got_of is not None:
                c_role, c_hits = got_of[g]
                calls = {pid: (self.role_ids[r], self._conv(h))
                         for pid, r, h in zip(ids, c_role, c_hits) if r >= 0}
            known = set(ids)
            for pid, r, h in zip(ids, w_role, w_hits):
                exp = ((self.role_ids[r], self._conv(h)) if r >= 0 else None)
                got = calls.get(pid)
                if got != exp:
                    n_bad += 1
                    if (got is None or exp is None) or got[0] != exp[0]:
                        n_role += 1
                    else:
                        gap = max(gap, abs(got[1] - exp[1]))
            n_bad += sum(1 for pid in calls if pid not in known)
            self.failed += int(n_bad > bad_before)
        checked = {"genomes_checked": (len(self.kept), None)}
        if self.weighted:
            return dict(checked,
                        role_mismatches=(n_role, limits["role_mismatches"]),
                        tally_gap=(gap, limits["tally_gap"]))
        return dict(checked,
                    call_mismatches=(n_bad, limits["call_mismatches"]))

    def _conv(self, h):
        return round(float(h), 4) if self.weighted else int(h)

    def _reference(self, table, tally_dtype=None) -> dict:
        import torch

        cfg, pool = self.config, self.pool
        need = sorted({g for g, _ in self.kept})
        out = {}
        for g in need:
            p0, p1 = pool["bounds"][g], pool["bounds"][g + 1]
            off = pool["offsets"][p0: p1 + 1]
            out[g] = ref.call(
                table, pool["letters"], off, cfg["k"], cfg["min_hits"],
                weighted=self.weighted, n_roles=cfg["roles"],
                tally_dtype=tally_dtype or torch.float64)
        return out
