"""BV-BRC (PATRIC) data-api client (the p3api jar's contract:
P3CursorConnection, KmerProcessor.java:127-131, and P3Genome.load(p3, id,
Details.PROTEINS, cacheDir), KmerProcessor.java:189-191).  A copy of the
reference package's ``genome/p3api.py``.

Design: a thin paged-query client over the public data API
(https://www.bv-brc.org/api) plus a GTO assembler.  Everything is
cache-first: ``P3Genome.load`` consults ``<cache>/<id>.gto`` before any
network call and writes fetched genomes back, so a network-isolated
deployment runs entirely from the cache; remote misses warn and return
None, exactly the reference tool's not-found path.  The HTTP layer is one
function (``_http_json``) so tests inject canned responses without
sockets.

Detail levels mirror P3Genome.Details: STRUCTURE_ONLY (genome record +
feature locations), PROTEINS (+ protein translations), FULL (+ contig
DNA).
"""

from __future__ import annotations

import json
import logging
import os
import urllib.parse
import urllib.request
from enum import Enum
from typing import Iterator

from .gto import Genome

log = logging.getLogger(__name__)

API_URL = "https://www.bv-brc.org/api"
LEGACY_GTO_URL = "https://p3.theseed.org/services/data_api/genome/"
PAGE_SIZE = 2500


def _http_json(url: str, timeout: float = 30.0):
    """GET a JSON document; raises on transport errors (callers decide
    whether a failure is fatal).  Tests monkeypatch THIS function."""
    req = urllib.request.Request(url, headers={
        "Accept": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.load(resp)


class Details(Enum):
    """How much of a genome to load (P3Genome.Details contract)."""

    STRUCTURE_ONLY = 0
    PROTEINS = 1
    FULL = 2


class P3Connection:
    """Paged RQL queries against the BV-BRC data API cores
    (P3CursorConnection contract: iterate large result sets without
    loading them whole)."""

    def __init__(self, api_url: str = API_URL, page_size: int = PAGE_SIZE):
        self.api_url = api_url.rstrip("/")
        self.page_size = page_size

    def query(self, core: str, *filters: str,
              select: "list[str] | None" = None) -> Iterator[dict]:
        """Iterate every record of ``core`` matching the RQL filters,
        fetching ``page_size`` records per request (cursor semantics)."""
        parts = list(filters)
        if select:
            parts.append("select(" + ",".join(select) + ")")
        base = "&".join(parts)
        offset = 0
        while True:
            rql = (f"{base}&limit({self.page_size},{offset})"
                   if base else f"limit({self.page_size},{offset})")
            url = f"{self.api_url}/{core}/?{rql}"
            page = _http_json(url)
            if not isinstance(page, list):
                raise ValueError(
                    f"unexpected {core} response shape: "
                    f"{type(page).__name__}")
            yield from page
            if len(page) < self.page_size:
                return
            offset += self.page_size

    @staticmethod
    def eq(field: str, value: str) -> str:
        return f"eq({field},{urllib.parse.quote(str(value), safe='')})"


def _feature_record_to_gto(rec: dict) -> dict:
    """One genome_feature record → GTO feature dict."""
    strand = rec.get("strand", "+")
    start = int(rec.get("start", 0))
    end = int(rec.get("end", 0))
    left, right = min(start, end), max(start, end)
    begin = left if strand == "+" else right
    feat = {
        "id": rec.get("patric_id") or rec.get("feature_id", ""),
        "type": rec.get("feature_type", "CDS"),
        "function": rec.get("product", ""),
        "location": [[rec.get("sequence_id", ""), str(begin), strand,
                      right - left + 1]],
        "annotations": [], "aliases": [],
    }
    if rec.get("aa_sequence"):
        feat["protein_translation"] = rec["aa_sequence"]
    if rec.get("plfam_id"):
        feat["family_assignments"] = [["PLFAM", rec["plfam_id"], ""]]
    return feat


class P3Genome:
    """Genome loader with on-disk GTO cache (P3Genome.load contract)."""

    @staticmethod
    def load(p3: P3Connection, genome_id: str,
             level: Details = Details.PROTEINS,
             cache_dir: str | None = None) -> Genome | None:
        """Cache-first load; None when the genome cannot be found (the
        caller skips + warns — KmerProcessor.java:190-191)."""
        if cache_dir is not None:
            p = os.path.join(cache_dir, genome_id + ".gto")
            if os.path.isfile(p):
                return Genome.load(p)
        genome = P3Genome._fetch(p3, genome_id, level)
        if genome is not None and cache_dir is not None:
            genome.save(os.path.join(cache_dir, genome_id + ".gto"))
        return genome

    @staticmethod
    def _fetch(p3: P3Connection, genome_id: str,
               level: Details) -> Genome | None:
        # 1) legacy GTO endpoint: one request, full GTO shape
        try:
            raw = _http_json(LEGACY_GTO_URL + genome_id)
            if isinstance(raw, dict) and (raw.get("contigs")
                                          or raw.get("features")):
                return Genome(raw)
        except Exception as exc:
            log.debug("legacy GTO endpoint failed for %s: %s",
                      genome_id, exc)
        # 2) assemble from the data-api cores
        try:
            recs = list(p3.query(
                "genome", p3.eq("genome_id", genome_id),
                select=["genome_id", "genome_name", "taxon_id",
                        "superkingdom", "genetic_code"]))
            if not recs:
                log.warning("Genome %s not found in BV-BRC.", genome_id)
                return None
            g = recs[0]
            gto = {
                "id": g.get("genome_id", genome_id),
                "scientific_name": g.get("genome_name", ""),
                "domain": g.get("superkingdom", "Bacteria"),
                "genetic_code": int(g.get("genetic_code", 11) or 11),
                "ncbi_taxonomy_id": g.get("taxon_id"),
                "features": [], "contigs": [],
                "close_genomes": [], "subsystems": [],
            }
            # every level loads feature structure; PROTEINS/FULL add the
            # aa sequences (Details.PROTEINS is what the projection
            # engine loads close genomes at — KmerProcessor.java:189)
            select = ["patric_id", "feature_id", "feature_type",
                      "product", "sequence_id", "start", "end",
                      "strand", "plfam_id"]
            if level in (Details.PROTEINS, Details.FULL):
                select.append("aa_sequence")
            gto["features"] = [
                _feature_record_to_gto(rec) for rec in p3.query(
                    "genome_feature", p3.eq("genome_id", genome_id),
                    p3.eq("annotation", "PATRIC"), select=select)]
            if level is Details.FULL:
                gto["contigs"] = [
                    {"id": rec.get("sequence_id", ""),
                     "dna": rec.get("sequence", "").lower(),
                     "genetic_code": gto["genetic_code"]}
                    for rec in p3.query(
                        "genome_sequence", p3.eq("genome_id", genome_id),
                        select=["sequence_id", "sequence"])]
            return Genome(gto)
        except Exception as exc:
            log.warning("Could not fetch genome %s: %s", genome_id, exc)
            return None
