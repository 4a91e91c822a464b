"""``updateJson`` — rewrite BV-BRC JSON dump directories with new GTO
annotations (UpdateJsonProcessor.java:56-385).

A copy of the reference package's ``commands/update_json_cmd.py``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import shutil

from ..genome.roles import RoleMap
from ..genome.sources import GenomeSource
from .base import BaseProcessor, ParseFailureException

log = logging.getLogger(__name__)

# genome_feature.json field schema (UpdateJsonProcessor.java:70-93)
FEATURE_FIELDS: dict[str, str] = {
    "patric_id": "string", "public": "boolean", "genome_name": "string",
    "genome_id": "string", "product": "string", "feature_type": "string",
    "accession": "string", "strand": "string", "start": "integer",
    "end": "integer", "location": "string", "aa_sequence_md5": "string",
    "aa_length": "integer", "na_sequence_md5": "string",
    "na_length": "integer", "refseq_locus_tag": "string", "gene": "string",
    "gene_id": "string", "annotation": "string", "protein_id": "string",
    "segments": "list", "taxon_id": "integer",
}

# files copied verbatim (UpdateJsonProcessor.java:95-96)
COPY_FILES = ("genome.json", "protein_structure.json", "sp_gene.json",
              "pathway.json", "ppi.json", "bioset_result.json",
              "genome_amr.json")

GENOME_DIR_RE = re.compile(r"\d+\.\d+")


def _coerce(value, json_type: str):
    """Typed field conversion (the JsonType enum's valueOf methods)."""
    if json_type == "string":
        return "" if value is None else str(value)
    if json_type == "integer":
        try:
            return int(value)
        except (TypeError, ValueError):
            return 0
    if json_type == "boolean":
        if isinstance(value, str):
            return value.strip().lower() in ("y", "yes", "true", "1")
        return bool(value)
    if json_type == "float":
        try:
            return float(value)
        except (TypeError, ValueError):
            return 0.0
    if json_type == "list":
        if value is None:
            return []
        return value if isinstance(value, list) else [value]
    return value


class UpdateJsonProcessor(BaseProcessor):

    HELP = "update annotations in JSON genome files"

    def add_options(self, parser: argparse.ArgumentParser) -> None:
        parser.add_argument("--clear", action="store_true",
                            help="erase the output directory before "
                                 "processing")
        parser.add_argument("--type", "-t", dest="source_type",
                            default="DIR", help="input genome source type")
        parser.add_argument("--roles", "-R", dest="role_file",
                            metavar="roles.in.subsystems",
                            default=os.path.join(os.getcwd(),
                                                 "roles.in.subsystems"),
                            help="role definition file")
        parser.add_argument("jsonInDir", metavar="jsonInDir",
                            help="JSON dump input master directory")
        parser.add_argument("genomeInDir", metavar="genomeInDir",
                            help="input genome source with new annotations")
        parser.add_argument("jsonOutDir", metavar="jsonOutDir",
                            help="JSON dump output master directory")

    def validate_parms(self) -> None:
        self.require_dir(self.jsonInDir, "Input JSON directory")
        self.genome_dirs = sorted(
            d for d in os.listdir(self.jsonInDir)
            if GENOME_DIR_RE.fullmatch(d)
            and os.path.isdir(os.path.join(self.jsonInDir, d)))
        if not self.genome_dirs:
            raise ParseFailureException(
                f"No genome subdirectories found in {self.jsonInDir}.")
        self.genomes = GenomeSource.create(self.source_type,
                                           self.genomeInDir)
        genome_ids = set(self.genomes.ids())
        bad = [g for g in self.genome_dirs if g not in genome_ids]
        if bad:
            raise ParseFailureException(
                f"{len(bad)} genomes from {self.jsonInDir} not found in "
                f"{self.genomeInDir}.")
        self.require_file(self.role_file, "Role definition file")
        self.role_map = RoleMap.load(self.role_file)
        os.makedirs(self.jsonOutDir, exist_ok=True)
        if self.clear:
            for name in os.listdir(self.jsonOutDir):
                p = os.path.join(self.jsonOutDir, name)
                shutil.rmtree(p) if os.path.isdir(p) else os.unlink(p)

    def _compute_role(self, sub, function: str) -> str | None:
        """Role of a feature in a subsystem, synonym-normalized
        (UpdateJsonProcessor.java:371-383)."""
        result = None
        roles = self.role_map.useful_roles(function)
        from ..genome.roles import normalize_role
        sub_roles = {normalize_role(r) for r in sub.roles}
        for role in roles:
            if role.normalized in sub_roles:
                result = role.name
        if result is None:
            log.error("Function %s not compatible with subsystem %s.",
                      function, sub.name)
        return result

    def run_command(self) -> None:
        substitutions = sub_records = copies = 0
        for g_count, genome_id in enumerate(self.genome_dirs, 1):
            genome = self.genomes.get(genome_id)
            log.info("Processing genome %d of %d: %s.", g_count,
                     len(self.genome_dirs), genome)
            in_dir = os.path.join(self.jsonInDir, genome_id)
            out_dir = os.path.join(self.jsonOutDir, genome_id)
            os.makedirs(out_dir, exist_ok=True)
            for name in COPY_FILES:
                src = os.path.join(in_dir, name)
                if os.path.exists(src):
                    shutil.copyfile(src, os.path.join(out_dir, name))
                    copies += 1
            feat_in = os.path.join(in_dir, "genome_feature.json")
            with open(feat_in) as fh:
                records = json.load(fh)
            feat_array = []
            sub_array = []
            for record in records:
                fid = record.get("patric_id", "")
                if fid:
                    product = record.get("product", "")
                    feat = genome.get_feature(fid)
                    if feat is None:
                        log.warning("%s not found in %s.", fid, genome)
                    else:
                        function = feat.peg_function
                        if function != product:
                            record = dict(record, product=function)
                            substitutions += 1
                        for sub in feat.subsystem_rows:
                            classes = sub.classifications
                            sub_obj = {
                                "patric_id": fid,
                                "role_name": self._compute_role(sub,
                                                                function),
                                "active": ("active" if sub.is_active
                                           else "inactive"),
                                "subsystem_name": sub.name,
                                "genome_id": genome_id,
                                "genome_name": genome.name,
                            }
                            for key, i in (("superclass", 0), ("class", 1),
                                           ("subclass", 2)):
                                if len(classes) > i:
                                    sub_obj[key] = classes[i]
                            sub_array.append(sub_obj)
                            sub_records += 1
                feat_array.append({
                    name: _coerce(record.get(name), jtype)
                    for name, jtype in FEATURE_FIELDS.items()})
            with open(os.path.join(out_dir, "genome_feature.json"),
                      "w") as fh:
                json.dump(feat_array, fh)
            with open(os.path.join(out_dir, "subsystem.json"), "w") as fh:
                json.dump(sub_array, fh)
        log.info("%d genomes processed, %d files copied, %d substitutions, "
                 "%d subsystem records output.", len(self.genome_dirs),
                 copies, substitutions, sub_records)
