"""The port's own host modules against the JAX package's originals.

The port keeps copies of the reference's jax-free host modules (GTO model,
locations, DNA translation, roles and function maps, genome sources and
targets, comparisons, subsystem projection, codecs, hashing, ORF
extension, peg proposals, tabular and FASTA I/O, counters, statistics,
annotation records, apply and annotation reporters, the command table and
the C++ host library ``native``).  Each copy must give what the original
gives on the same inputs, made from a seed.
"""

import io
import json
import math
import os
import time

import numpy as np
import pytest

from kmers_anno_tpu import native as ref_native
from kmers_anno_tpu.commands import app as ref_app
from kmers_anno_tpu.commands import base as ref_base
from kmers_anno_tpu.engine import annotation as ref_annotation
from kmers_anno_tpu.engine import proposals as ref_proposals
from kmers_anno_tpu.genome import compare as ref_compare
from kmers_anno_tpu.genome import dna as ref_dna
from kmers_anno_tpu.genome import gto as ref_gto
from kmers_anno_tpu.genome import locations as ref_loc
from kmers_anno_tpu.genome import roles as ref_roles
from kmers_anno_tpu.genome import sources as ref_sources
from kmers_anno_tpu.genome import subsystems as ref_subsystems
from kmers_anno_tpu.ops import encode as ref_enc
from kmers_anno_tpu.ops import hashing as ref_hashing
from kmers_anno_tpu.ops import orf as ref_orf
from kmers_anno_tpu.reports import annotation_reports as ref_anno_reports
from kmers_anno_tpu.reports import apply_reports as ref_reports
from kmers_anno_tpu.utils import counters as ref_counters
from kmers_anno_tpu.utils import io as ref_io
from kmers_anno_tpu.utils import stats as ref_stats
from kmers_anno_tpu_torch import native
from kmers_anno_tpu_torch.commands import app, base
from kmers_anno_tpu_torch.engine import annotation, proposals
from kmers_anno_tpu_torch.genome import (compare, dna, gto, locations, roles,
                                         sources, subsystems)
from kmers_anno_tpu_torch.ops import encode, hashing, orf
from kmers_anno_tpu_torch.reports import annotation_reports, apply_reports
from kmers_anno_tpu_torch.utils import counters, stats
from kmers_anno_tpu_torch.utils import io as port_io

from tests.fixtures import (make_genome, make_projection_pair,
                            write_role_files)

SEEDS = (0, 1, 2)


def _text(rng, alphabet: str, n: int) -> str:
    return "".join(rng.choice(list(alphabet), n))


def _genome_raw(seed):
    new, olds = make_projection_pair(seed=seed, n_genes=6)
    raw = json.loads(json.dumps(new.raw))
    raw["features"] = json.loads(json.dumps(
        next(iter(olds.values())).raw["features"]))
    raw["contigs"].append({"id": "c2", "dna": "acgtnacgt" * 30})
    raw["close_genomes"] = [
        {"genome": "9.1", "closeness_measure": 50.0},
        {"genome": "8.1", "genome_name": "Eight", "closeness_measure": 80.0},
        {"genome_id": "7.1", "closeness_measure": 80.0}]
    raw["features"].append({
        "id": "fig|400.1.rna.1", "type": "rna", "function": "",
        "location": [["newcon", "300", "-", 60], ["newcon", "100", "-", 30]]})
    raw["unknown_key"] = {"kept": [1, 2, 3]}
    return raw


# ---------------------------------------------------------------------------
# codecs and hashing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_codecs_match_reference(seed):
    rng = np.random.default_rng(seed)
    prot = _text(rng, "ACDEFGHIKLMNPQRSTVWYXacdwy*-?Bz", 500)
    dna_s = _text(rng, "acgtuACGTUnNryRY-", 500)
    np.testing.assert_array_equal(encode.encode_protein(prot),
                                  ref_enc.encode_protein(prot))
    np.testing.assert_array_equal(encode.encode_dna(dna_s),
                                  ref_enc.encode_dna(dna_s))
    codes = rng.integers(0, 32, 300).astype(np.uint8)
    assert encode.decode_protein(codes) == ref_enc.decode_protein(codes)
    dcodes = rng.integers(0, 5, 300).astype(np.uint8)
    np.testing.assert_array_equal(encode.reverse_complement_codes(dcodes),
                                  ref_enc.reverse_complement_codes(dcodes))
    for name in ("PROT_STOP", "PROT_OTHER", "PROT_PAD", "PROT_X",
                 "DNA_AMBIG"):
        assert getattr(encode, name) == getattr(ref_enc, name)


@pytest.mark.parametrize("seed", SEEDS)
def test_numpy_mixers_match_reference(seed):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 1 << 32, 1000, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, 1000, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(hashing.mix_kmer_np(lo, hi),
                                  ref_hashing.mix_kmer(lo, hi, np))
    for salt in ref_hashing.salt_sequence(4) + [0, 0xFFFFFFFF]:
        np.testing.assert_array_equal(
            hashing.mix_kmer_salted_np(lo, hi, salt),
            ref_hashing.mix_kmer_salted(lo, hi, np.uint32(salt), np))
    assert hashing.salt_sequence(32) == ref_hashing.salt_sequence(32)
    assert (hashing.GOLDEN, hashing.M1, hashing.M2) == (
        ref_hashing.GOLDEN, ref_hashing._M1, ref_hashing._M2)


# ---------------------------------------------------------------------------
# DNA translation, locations and ORF extension
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gc", [1, 2, 3, 4, 11])
def test_dna_translator_matches_reference(gc):
    rng = np.random.default_rng(gc)
    port, ref = dna.DnaTranslator(gc), ref_dna.DnaTranslator(gc)
    assert np.array_equal(port.code.aa_lut(), ref.code.aa_lut())
    assert port.code.starts == ref.code.starts
    assert port.code.stops == ref.code.stops
    for n in (0, 2, 30, 71, 72, 300, 1001):
        for alphabet in ("acgt", "acgtACGTn", "acgtu"):
            s = _text(rng, alphabet, n)
            for frame in (1, 2, 3):
                assert port.translate(s, frame) == ref.translate(s, frame)
                assert (port.peg_translate(s, frame, n - 3)
                        == ref.peg_translate(s, frame, n - 3))
    s = _text(rng, "acgt", 100)
    assert dna.reverse_complement(s + "nry") == ref_dna.reverse_complement(
        s + "nry")
    with pytest.raises(ValueError):
        dna.GeneticCode(5)


@pytest.mark.parametrize("seed", SEEDS)
def test_location_matches_reference(seed):
    rng = np.random.default_rng(seed)
    seq = _text(rng, "acgtn", 400)
    for _ in range(50):
        left = int(rng.integers(1, 300))
        right = left + int(rng.integers(0, 90))
        strand = "+" if rng.random() < 0.5 else "-"
        port = locations.Location("c", strand, left, right)
        ref = ref_loc.Location("c", strand, left, right)
        assert (port.length, port.begin, port.end, str(port),
                port.dna(seq)) == (ref.length, ref.begin, ref.end, str(ref),
                                   ref.dna(seq))
        begin = int(rng.integers(1, 400))
        port.set_begin(begin)
        ref.set_begin(begin)
        assert (port.left, port.right) == (ref.left, ref.right)


@pytest.mark.parametrize("seed", SEEDS)
def test_orf_extender_matches_reference(seed):
    """The port's batch OrfExtender against the reference's, element by
    element against the reference's scalar ``OrfExtender.extend``, and
    against the scalar walker ``Location.extend`` inside the contig."""
    rng = np.random.default_rng(seed)
    new, _ = make_projection_pair(seed=seed, n_genes=6)
    genome = ref_gto.Genome(json.loads(json.dumps(new.raw)))
    contig = genome.contigs[0]
    port, ref = orf.OrfExtender(genome), ref_orf.OrfExtender(genome)
    m = 300
    strands = rng.integers(0, 2, m)
    lefts = rng.integers(-5, contig.length + 5, m)
    lengths = 3 * rng.integers(1, 40, m) - (rng.random(m) < 0.1)
    rights = lefts + lengths - 1
    contig_idx = (rng.random(m) < 0.05).astype(np.int64)   # 1 = missing
    ids = [contig.id, "missing"]
    got = port.extend_batch(contig_idx, ids, strands, lefts, rights)
    want = ref.extend_batch(contig_idx, ids, strands, lefts, rights)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for i in range(m):
        loc = ref_loc.Location(ids[contig_idx[i]],
                               "+" if strands[i] == 0 else "-",
                               int(lefts[i]), int(rights[i]))
        mine = (int(got[0][i]), int(got[1][i])) if got[2][i] else None
        assert mine == ref.extend(loc)
        if 1 <= loc.left and loc.right <= contig.length:
            walked = loc.extend(genome)
            assert mine == (None if walked is None
                            else (walked.left, walked.right))


# ---------------------------------------------------------------------------
# GTO model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_gto_round_trip_matches_reference(seed, tmp_path):
    raw = _genome_raw(seed)
    path = tmp_path / "g.gto"
    path.write_text(json.dumps(raw))
    port = gto.Genome.load(str(path))
    ref = ref_gto.Genome.load(str(path))
    assert (port.id, port.name, port.genetic_code, str(port)) == (
        ref.id, ref.name, ref.genetic_code, str(ref))
    assert [(c.id, c.sequence, c.genetic_code, len(c))
            for c in port.contigs] == [(c.id, c.sequence, c.genetic_code,
                                        len(c)) for c in ref.contigs]
    assert [(f.id, f.type, f.function, f.protein_translation,
             f.protein_length, str(f.location), [str(r) for r in f.regions])
            for f in port.features] == [
        (f.id, f.type, f.function, f.protein_translation, f.protein_length,
         str(f.location), [str(r) for r in f.regions])
        for f in ref.features]
    assert [f.id for f in port.pegs] == [f.id for f in ref.pegs]
    assert [(c.genome_id, c.genome_name, c.closeness)
            for c in port.close_genomes] == [
        (c.genome_id, c.genome_name, c.closeness) for c in ref.close_genomes]
    loc = port.pegs[0].location
    assert port.get_dna(loc) == ref.get_dna(loc)
    assert port.get_dna(locations.Location("none", "+", 1, 9)) == ""
    for g, create in ((port, gto.Feature.create),
                      (ref, ref_gto.Feature.create)):
        feat = create("fig|400.1.peg.99", "New role", "newcon", "-", 10, 99)
        feat.protein_translation = "MKV"
        feat.function = "New role two"
        g.add_feature(feat)
        g.de_annotate()
        g.add_feature(create("fig|400.1.peg.100", "R", "newcon", "+", 4, 9))
    outs = []
    for g in (port, ref):
        buf = io.StringIO()
        g.save(buf)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert json.loads(outs[0])["unknown_key"] == {"kept": [1, 2, 3]}
    for g in (port, ref):
        g.save(str(tmp_path / f"{id(g)}.gto"))
    assert (tmp_path / f"{id(port)}.gto").read_text() == (
        tmp_path / f"{id(ref)}.gto").read_text()


def test_genome_directory_matches_reference(tmp_path):
    for i in range(3):
        make_genome(f"{50 + i}.1", seed=i).save(
            str(tmp_path / f"{50 + i}.1.gto"))
    (tmp_path / "notes.txt").write_text("x")
    port = gto.GenomeDirectory(str(tmp_path))
    ref = ref_gto.GenomeDirectory(str(tmp_path))
    assert (len(port), port.ids) == (len(ref), ref.ids)
    assert [g.id for g in port] == [g.id for g in ref]


def test_peg_function_and_md5_match_reference():
    raw = _genome_raw(0)
    raw["features"][0]["function"] = ""
    port, ref = gto.Genome(raw), ref_gto.Genome(raw)
    assert [f.peg_function for f in port.features] == [
        f.peg_function for f in ref.features]
    assert port.features[0].peg_function == "hypothetical protein"
    for prot in ("MKVLAA", "mkvlaa*", ""):
        assert gto.protein_md5(prot) == ref_gto.protein_md5(prot)


def test_genome_sources_match_reference(tmp_path):
    for i in range(3):
        make_genome(f"{70 + i}.1", seed=i).save(
            str(tmp_path / f"{70 + i}.1.gto"))
    (tmp_path / "notes.txt").write_text("x")
    for type_name in ("DIR", "dir", "PATRIC"):
        port = sources.GenomeSource.create(type_name, str(tmp_path))
        ref = ref_sources.GenomeSource.create(type_name, str(tmp_path))
        assert type(port).__name__ == type(ref).__name__
        assert (len(port), port.ids()) == (len(ref), ref.ids())
        if type_name != "PATRIC":
            assert [g.id for g in port] == [g.id for g in ref]
            assert port.get("99.9") is None and ref.get("99.9") is None
    assert isinstance(sources.PatricGenomeSource(str(tmp_path)),
                      sources.GenomeSource)
    for create in (sources.GenomeSource.create,
                   ref_sources.GenomeSource.create):
        with pytest.raises(ValueError):
            create("NOPE", str(tmp_path))
        with pytest.raises(FileNotFoundError):
            create("DIR", str(tmp_path / "missing"))


def test_multi_report_processor_matches_reference(tmp_path, monkeypatch):
    """-D / --clear and the output directory's preparation."""
    monkeypatch.setenv("KMERS_ANNO_LOG", "off")
    outs = []
    for module, tag in ((base, "port"), (ref_base, "ref")):
        out = tmp_path / tag
        out.mkdir()
        (out / "old.tbl").write_text("x")
        (out / "keep").mkdir()
        proc = module.BaseMultiReportProcessor()
        proc.parse("t", ["-D", str(out), "--clear"])
        proc.prepare_out_dir()
        outs.append((sorted(os.listdir(out)),
                     os.path.relpath(proc.out_file("a.tbl"), tmp_path)
                     .replace(tag, "")))
        fresh = module.BaseMultiReportProcessor()
        fresh.parse("t", ["-D", str(tmp_path / tag / "new")])
        fresh.prepare_out_dir()
        assert os.path.isdir(tmp_path / tag / "new")
        assert fresh.default_out_dir() == os.getcwd()
    assert outs[0] == outs[1] == (["keep"], "/a.tbl")


def test_annotation_names_match_reference():
    assert annotation.OUTPUT_HEADER == ref_annotation.OUTPUT_HEADER
    assert annotation.ANNO_FILE_RE.pattern == ref_annotation.ANNO_FILE_RE.pattern
    for name in ("83333.1.anno.tbl", "83333.anno.tbl", "1.2.anno.tbl.bak"):
        assert (bool(annotation.ANNO_FILE_RE.fullmatch(name))
                == bool(ref_annotation.ANNO_FILE_RE.fullmatch(name)))


def test_annotation_history_matches_reference():
    port = gto.Feature.create("f", "F", "c", "+", 1, 9)
    ref = ref_gto.Feature.create("f", "F", "c", "+", 1, 9)
    for f in (port, ref):
        f.add_annotation("Set function to F", "kmers_anno")
    assert [a[:2] + a[3:] for a in port.raw["annotations"]] == [
        a[:2] + a[3:] for a in ref.raw["annotations"]]


# ---------------------------------------------------------------------------
# roles, tabular readers, counters, reporters, the command table
# ---------------------------------------------------------------------------

def test_role_map_matches_reference(tmp_path):
    role_file, _ = write_role_files(tmp_path)
    port = roles.RoleMap.load(role_file)
    ref = ref_roles.RoleMap.load(role_file)
    assert (len(port), list(port.ids())) == (len(ref), list(ref.ids()))
    for fun in ("LSU ribosomal protein L2p", "Seryl-tRNA synthetase (EC 6.1.1.11)",
                "DNA polymerase III alpha subunit / LSU ribosomal protein L2p",
                "Seryl-tRNA synthetase # comment", "hypothetical protein",
                "", "LSU  ribosomal PROTEIN L2p; Seryl-tRNA synthetase"):
        assert [r.id for r in port.useful_roles(fun)] == [
            r.id for r in ref.useful_roles(fun)]
    for rid in list(ref.ids()) + ["NoSuchRole"]:
        assert port.get_name(rid) == ref.get_name(rid)
    port.save(str(tmp_path / "port.roles"))
    ref.save(str(tmp_path / "ref.roles"))
    assert (tmp_path / "port.roles").read_text() == (
        tmp_path / "ref.roles").read_text()
    assert roles.role_checksum("A (EC 1.2.3.4)") == ref_roles.role_checksum(
        "A (EC 1.2.3.4)")


def _field(reader, name):
    try:
        return reader.find_field(name)
    except KeyError:
        return "KeyError"


def test_tabbed_readers_match_reference(tmp_path):
    path = tmp_path / "t.tsv"
    path.write_text("genome_id\tname\tx\n1.1\tOne\t7\n\n2.2\tTwo\r\n"
                    "3.3\tThree\t9\n")
    for columns in (None, 2, 3):
        with port_io.TabbedLineReader(str(path), columns) as p, \
                ref_io.TabbedLineReader(str(path), columns) as r:
            assert p.labels == r.labels
            for name in ("name", "x", "1", "3", "4", "nope"):
                assert _field(p, name) == _field(r, name)
            assert [(x.fields, x.get(0), x.get(5)) for x in p] == [
                (x.fields, x.get(0), x.get(5)) for x in r]
    assert port_io.read_set(str(path), "1") == ref_io.read_set(str(path), "1")
    assert port_io.read_set(str(path), "name") == ref_io.read_set(
        str(path), "name")
    assert port_io.LineReader.read_set(str(path)) == (
        ref_io.LineReader.read_set(str(path)))
    with port_io.LineReader(str(path)) as p, ref_io.LineReader(str(path)) as r:
        assert list(p) == list(r)


def test_count_map_matches_reference():
    rng = np.random.default_rng(3)
    keys = [f"k{int(k)}" for k in rng.integers(0, 40, 500)]
    port, ref = counters.CountMap(), ref_counters.CountMap()
    for key in keys:
        assert port.count(key) == ref.count(key)
    port.count("k1", 5)
    ref.count("k1", 5)
    assert (port.size(), len(port), sorted(port.keys()), sorted(port.counts()),
            port.singletons(), port.get_count("none")) == (
        ref.size(), len(ref), sorted(ref.keys()), sorted(ref.counts()),
        ref.singletons(), ref.get_count("none"))
    assert [c for _, c in port.sorted_counts()] == [
        c for _, c in ref.sorted_counts()]
    port.delete_all()
    assert len(port) == 0


@pytest.mark.parametrize("fmt", ["APPLY", "VERIFY"])
def test_apply_reporters_match_reference(fmt, tmp_path):
    _, use_file = write_role_files(tmp_path)
    genomes = [make_genome(f"{60 + i}.1", seed=i) for i in range(2)]
    outs = []
    for module in (apply_reports, ref_reports):
        buf = io.StringIO()
        rep = module.ApplyKmerReporter.create(fmt, buf)
        rep.init_report(use_file)
        for g in genomes:
            rep.open_genome(g)
            for i, f in enumerate(g.pegs):
                rep.record_feature(f, ["PhenTrnaSyntAlph", "HypoProt",
                                       "SeryTrnaSynt"][i % 3], i)
            rep.close_genome()
        rep.close_report()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0]


def test_command_table_matches_reference():
    """Every command of the reference, in its order and with its
    description, has a processor of the same class in the port."""
    assert [(name, desc) for name, (_, desc) in app.COMMANDS.items()] == [
        (name, desc) for name, (_, desc) in ref_app.COMMANDS.items()]
    assert len(app.COMMANDS) == 16
    for name, (factory, _) in app.COMMANDS.items():
        proc = factory()
        ref = ref_app.COMMANDS[name][0]()
        assert type(proc).__name__ == type(ref).__name__
        assert type(proc).__module__.startswith("kmers_anno_tpu_torch.")
        assert proc.HELP == ref.HELP


# ---------------------------------------------------------------------------
# annotation records, statistics and the annotation reporters
# ---------------------------------------------------------------------------

def _anno_dir(tmp_path, seed):
    """An annotation directory: three ``.anno.tbl`` files with scores of
    every kind (empty, unparsable, zero, NaN), a file the scanner skips and
    a ``changes.tbl``."""
    rng = np.random.default_rng(seed)
    d = tmp_path / f"annos{seed}"
    d.mkdir()
    news = ["hypothetical protein", "Role A", "Role B", "Role C"]
    for gid in ("83333.1", "9.12", "511145.183"):
        with open(d / f"{gid}.anno.tbl", "w") as fh:
            fh.write("fid\tscore\tnew_annotation\told_annotation\n")
            for i in range(40):
                score = rng.choice(["", "x", "0.0", "nan", "1.0",
                                    repr(float(rng.random()))])
                fh.write(f"fig|{gid}.peg.{i}\t{score}\t"
                         f"{news[rng.integers(0, 4)]}\t"
                         f"{news[rng.integers(0, 4)]}\n")
    (d / "83333.anno.tbl").write_text("fid\tscore\n")
    (d / "notes.txt").write_text("x")
    (d / "changes.tbl").write_text(
        "fid\tscore\tnew_annotation\told_annotation\n")
    return str(d)


def _anno_fields(a):
    return (a.fid, repr(a.score), a.old_annotation, a.new_annotation,
            a.is_good, a.is_hypothetical, a.is_null, a.key(), hash(a))


@pytest.mark.parametrize("seed", SEEDS)
def test_annotation_records_match_reference(seed, tmp_path):
    d = _anno_dir(tmp_path, seed)
    port_map = annotation.get_anno_map(d)
    ref_map = ref_annotation.get_anno_map(d)
    assert list(port_map.items()) == list(ref_map.items())
    assert list(port_map) == ["511145.183", "83333.1", "9.12"]
    for path in port_map.values():
        with port_io.TabbedLineReader(path) as p, \
                ref_io.TabbedLineReader(path) as r:
            got = list(annotation.iter_annotations(p))
            want = list(ref_annotation.iter_annotations(r))
        assert [_anno_fields(a) for a in got] == [
            _anno_fields(a) for a in want]
        # membership by the (old, new) pair only, as the reference's
        assert [a in set(got[:10]) for a in got] == [
            a in set(want[:10]) for a in want]
    for get in (annotation.get_anno_map, ref_annotation.get_anno_map):
        with pytest.raises(FileNotFoundError):
            get(str(tmp_path / "missing"))


JAVA_DOUBLES = [
    (math.nan, "NaN"), (math.inf, "Infinity"), (-math.inf, "-Infinity"),
    (0.0, "0.0"), (-0.0, "-0.0"), (1.0, "1.0"), (100.0, "100.0"),
    (-3.0, "-3.0"), (1e-3, "0.001"), (1e7, "1.0E7"), (1e-4, "1.0E-4"),
    (2.5e7, "2.5E7"), (0.1, "0.1"), (123456.789, "123456.789"),
    (1e21, "1.0E21"), (1e16, "1.0E16"), (5e-324, "4.9E-324")]


def test_java_double_matches_reference():
    """``java_double`` at its boundaries: NaN, the infinities, both zeros,
    integral values, 1e-3 and 1e7 and their neighbours on each side, and
    values whose ``repr`` is in exponent form; then seeded values over 40
    decades.  A few are pinned to Java's ``Double.toString``."""
    edges = [x for x, _ in JAVA_DOUBLES]
    for b in (1e-3, 1e7):
        edges += [np.nextafter(b, 0.0), np.nextafter(b, np.inf), -b]
    edges += [1.7976931348623157e308, 2.2250738585072014e-308, 1e-5,
              1.5e-5, 9999999.999999998, 1e22, 1.23456789e-7, 1 / 3,
              -2.5e-8, 4.35, 1e-300]
    rng = np.random.default_rng(5)
    edges += list(rng.random(300) * 10.0 ** rng.integers(-20, 20, 300))
    for x in edges:
        assert stats.java_double(float(x)) == ref_stats.java_double(
            float(x)), x
    for x, want in JAVA_DOUBLES:
        if x != 5e-324:     # Java prints the subnormal minimum differently
            assert stats.java_double(x) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_summary_statistics_match_reference(seed):
    rng = np.random.default_rng(seed)
    values = list(rng.random(200) * 10.0 ** rng.integers(-8, 8, 200))
    for n in (0, 1, 2, 3, 200):
        port, ref = stats.SummaryStatistics(), ref_stats.SummaryStatistics()
        for x in values[:n]:
            port.add_value(float(x))
            ref.add_value(float(x))
        got = (port.n, port.mean, port.minimum, port.maximum, port.std)
        want = (ref.n, ref.mean, ref.minimum, ref.maximum, ref.std)
        assert [repr(v) for v in got] == [repr(v) for v in want]


def _rich_raw(seed):
    """A GTO with aliases of every form, protein families, features bound
    by one, two or no subsystem rows and a row with no bindings."""
    raw = _genome_raw(seed)
    feats = raw["features"]
    feats[0]["aliases"] = [["gene_name", "abcA"], "bare", ["LocusTag", "L1"],
                           ["gene_name", "abcA"]]
    feats[1]["aliases"] = ["x", "x"]
    feats[1]["family_assignments"] = [["PGFAM", "PGF_1", "F"],
                                      ["PLFAM", "PLF_2", "F"], "odd"]
    feats[2]["function"] = ""
    feats[3].pop("aliases", None)
    raw["subsystems"] = [
        {"name": "Sub one", "variant_code": "active",
         "classification": ["A", "B", "C", "D"],
         "role_bindings": [{"role_id": "R1",
                            "features": [feats[0]["id"], feats[1]["id"]]}]},
        {"name": "Sub two", "variant_code": "-1", "classification": ["A"],
         "role_bindings": [{"role_id": "R2", "features": [feats[1]["id"]]},
                           {"role_id": "R3"}]},
        {"name": "Sub three", "role_bindings": []}]
    return raw


def _feature_view(f, role_map):
    return (f.id, f.md5, f.aliases, f.alias_map, f.gene_name, f.plfam,
            f.pgfam, [r.raw for r in f.subsystem_rows],
            f.is_interesting(role_map), f.peg_function)


@pytest.mark.parametrize("seed", SEEDS)
def test_gto_subsystems_and_aliases_round_trip(seed, tmp_path):
    """A GTO with subsystem rows and aliases saves byte-equal to the
    reference's when no command touches them, and after the same edits."""
    role_file, _ = write_role_files(tmp_path)
    raw = _rich_raw(seed)
    path = tmp_path / "g.gto"
    path.write_text(json.dumps(raw))
    port, ref = gto.Genome.load(str(path)), ref_gto.Genome.load(str(path))
    saved = []
    for g in (port, ref):
        buf = io.StringIO()
        g.save(buf)
        saved.append(buf.getvalue())
    assert saved[0] == saved[1]
    assert json.loads(saved[0])["subsystems"] == raw["subsystems"]
    port_roles = roles.RoleMap.load(role_file)
    ref_roles_ = ref_roles.RoleMap.load(role_file)
    assert [(c.r_sequence, c.seq_lower) for c in port.contigs] == [
        (c.r_sequence, c.seq_lower) for c in ref.contigs]
    assert (port.md5, port.length) == (ref.md5, ref.length)
    assert [_feature_view(f, port_roles) for f in port.features] == [
        _feature_view(f, ref_roles_) for f in ref.features]
    assert [(s.name, s.classifications, s.variant_code, s.is_active,
             s.roles, sorted(s.feature_ids())) for s in port.subsystems] == [
        (s.name, s.classifications, s.variant_code, s.is_active, s.roles,
         sorted(s.feature_ids())) for s in ref.subsystems]
    for fid in [f.id for f in ref.features] + ["fig|1.1.peg.0"]:
        got, want = port.get_feature(fid), ref.get_feature(fid)
        assert (got and got.id) == (want and want.id)
    for fid in ("fig|83333.1.peg.7", "fig|83333.peg.7", "nope"):
        assert gto.Feature.genome_of(fid) == ref_gto.Feature.genome_of(fid)
    for dna_ in ("acgtN", "ACGTN", ""):
        assert gto.dna_md5(dna_) == ref_gto.dna_md5(dna_)
    for g in (port, ref):
        f0, f1, f2 = g.features[:3]
        f0.gene_name = "newG"
        f1.gene_name = ""
        f0.plfam = "PLF_9"
        f1.pgfam = None
        f2.pgfam = "PGF_3"
        f2.add_alias("gene_name", "zz")
        f2.add_alias("gene_name", "zz")
        g.features[3].add_alias("misc", "bare")
        g.add_feature(type(f0).create("fig|400.1.peg.500", "F", "newcon",
                                      "+", 1, 9))
        assert g.get_feature("fig|400.1.peg.500") is g.features[-1]
        g.clear_subsystems()
        assert g.subsystem_rows_of(f0.id) == []
    for g in (port, ref):
        g.save(str(tmp_path / f"{id(g)}.gto"))
    assert (tmp_path / f"{id(port)}.gto").read_text() == (
        tmp_path / f"{id(ref)}.gto").read_text()


@pytest.mark.parametrize("fmt", ["FULL", "NEW_ROLES", "new_roles"])
def test_annotation_reporters_match_reference(fmt):
    raw = _rich_raw(0)
    new_raw = json.loads(json.dumps(raw))
    for i, f in enumerate(new_raw["features"]):
        if i % 3 == 0:
            f["function"] = f"Changed {i}"
    new_raw["features"][2]["function"] = "Not hypothetical"
    new_raw["subsystems"] = new_raw["subsystems"][1:] + [
        {"name": "New sub", "classification": ["X", "Y"],
         "role_bindings": [{"role_id": "Q", "features": [
             f["id"] for f in new_raw["features"][:3]]}]}]
    outs = []
    for module, gmod in ((annotation_reports, gto),
                         (ref_anno_reports, ref_gto)):
        old, new = gmod.Genome(json.loads(json.dumps(raw))), gmod.Genome(
            json.loads(json.dumps(new_raw)))
        buf = io.StringIO()
        rep = module.AnnotationReporter.create(fmt)
        rep.start_report(None, buf)
        for f in old.features:
            rep.process_feature(f, new.get_feature(f.id))
        rep.finish_report()
        outs.append((buf.getvalue(), rep.counter))
        with pytest.raises(ValueError):
            module.AnnotationReporter.create("BOGUS")
    assert outs[0] == outs[1]
    assert outs[0][1] > 0


# ---------------------------------------------------------------------------
# function maps, genome targets, FASTA, comparisons, subsystem projection
# ---------------------------------------------------------------------------

FUNCTION_NAMES = [
    "Phenylalanyl-tRNA synthetase alpha chain",
    "Phenylalanyl-tRNA synthetase alpha chain (EC 6.1.1.20)",
    "phenylalanyl-tRNA  synthetase ALPHA chain",
    "Phenylalanyl-tRNA synthetase alpha chain beta",
    "Phenylalanyl-tRNA synthetase alpha chain, type 2",
    "Phen tRNA Synt Alph", "PhenTrnaSyntAlph", "PhenTrnaSyntAlph2",
    "the and of", "", "Role", "hypothetical protein",
    "Hypothetical protein", "A / B", "x" * 30, "DNA pol III (TC 1.2.3)"]


def test_function_map_and_magic_ids_match_reference():
    """The same ids in the same insertion order, with the numbered
    suffixes on collisions, in both packages."""
    rng = np.random.default_rng(2)
    names = FUNCTION_NAMES + [FUNCTION_NAMES[i] for i in
                              rng.integers(0, len(FUNCTION_NAMES), 40)]
    port, ref = roles.FunctionMap(), ref_roles.FunctionMap()
    got = [(f.id, f.name, f.normalized)
           for f in map(port.find_or_insert, names)]
    want = [(f.id, f.name, f.normalized)
            for f in map(ref.find_or_insert, names)]
    assert got == want
    assert {"PhenTrnaSyntAlph2", "PhenTrnaSyntAlph3", "Role",
            "Role2"} <= {i for i, _, _ in got}
    assert len(port) == len(ref)
    for name in names + ["never seen"]:
        p, r = port.get_by_name(name), ref.get_by_name(name)
        assert (p and p.id) == (r and r.id)
    for fid in [i for i, _, _ in want] + ["Nope"]:
        assert port.get_name(fid) == ref.get_name(fid)
        assert (port.get_by_id(fid) is None) == (ref.get_by_id(fid) is None)
    taken = set()
    for name in names:
        a, b = roles.magic_id(name, taken), ref_roles.magic_id(name, taken)
        assert a == b
        taken.add(a)


def test_role_map_lookups_match_reference(tmp_path):
    role_file, _ = write_role_files(tmp_path)
    port, ref = roles.RoleMap.load(role_file), ref_roles.RoleMap.load(
        role_file)
    for rid in list(ref.ids()) + ["NoSuchRole"]:
        assert (rid in port) == (rid in ref)
        p, r = port.get(rid), ref.get(rid)
        assert (p and (p.id, p.name)) == (r and (r.id, r.name))
    for text in FUNCTION_NAMES + ["LSU ribosomal protein L2p",
                                  "lsu  RIBOSOMAL protein L2p (EC 1.1.1.1)"]:
        assert port.contains_name(text) == ref.contains_name(text)
        for rid in ref.ids():
            assert port.get(rid).matches(text) == ref.get(rid).matches(text)


def _target_outputs(module, gmod, root, genomes, fasta_width=None):
    out = {}
    for kind in ("DIR", "LIST", "DNAFASTA", "list"):
        path = str(root / kind)
        for clear in (False, False, True, False):
            target = module.GenomeTarget.create(kind, path, clear=clear)
            for raw in genomes:
                target.add(gmod.Genome(json.loads(json.dumps(raw))))
            target.close()
        if os.path.isdir(path):
            (root / kind / "keep.txt").write_text("x")
            module.GenomeTarget.create(kind, path, clear=True).close()
            out[kind] = {n: open(os.path.join(path, n)).read()
                         for n in sorted(os.listdir(path))}
        else:
            out[kind] = open(path).read()
    with pytest.raises(ValueError):
        module.GenomeTarget.create("BOGUS", str(root / "x"))
    return out


def test_genome_targets_match_reference(tmp_path):
    genomes = [_rich_raw(s) for s in SEEDS]
    for i, raw in enumerate(genomes):
        raw["id"] = f"{70 + i}.1"
        raw["contigs"][0]["dna"] = "acgtn" * (13 * i + 5)
    port = _target_outputs(sources, gto, tmp_path / "port", genomes)
    ref = _target_outputs(ref_sources, ref_gto, tmp_path / "ref", genomes)
    assert port == ref
    assert port["DIR"] == {"keep.txt": "x"}
    # the last add after the clearing one appended
    assert port["LIST"].count("\n") == 2 * len(genomes)
    assert port["DNAFASTA"].count(">") == 2 * sum(
        len(raw["contigs"]) for raw in genomes)


def _fasta_records(rng, n=12):
    out = []
    for i in range(n):
        comment = "" if i % 3 == 0 else f"genome {i} of the set"
        length = int(rng.integers(0, 200)) if i else 0
        out.append((f"rec{i}", comment, _text(rng, "acgtn", length)))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_fasta_reader_and_writer_match_reference(seed, tmp_path):
    rng = np.random.default_rng(seed)
    records = _fasta_records(rng)
    for width in (60, 7):
        texts = []
        for module in (port_io, ref_io):
            path = str(tmp_path / f"{module.__name__}.{width}.fna")
            with module.FastaWriter(path, width=width) as w:
                for rec in records:
                    w.write(module.Sequence(*rec))
            texts.append(open(path).read())
            buf = io.StringIO()
            module.FastaWriter(buf, width=width).write(
                module.Sequence(*records[1]))
            texts.append(buf.getvalue())
        assert texts[0] == texts[2] and texts[1] == texts[3]
        path = str(tmp_path / f"{port_io.__name__}.{width}.fna")
        with port_io.FastaReader(path) as p, ref_io.FastaReader(path) as r:
            got, want = list(p), list(r)
        assert [(s.label, s.comment, s.sequence) for s in got] == [
            (s.label, s.comment, s.sequence) for s in want] == records
        with open(path) as fh:
            assert [(s.label, s.comment, s.sequence)
                    for s in port_io.FastaReader(fh)] == records


# headers with two blanks, a tab and a trailing blank after the label,
# blanks inside sequence lines, an empty line between records
RAGGED_FASTA = (">a1  two blanks here\nACDE FG\nHIK\n>b2\tTabbed comment\n"
                "MM\n\n>c3 \nPP Q\n")


def test_fasta_reader_on_a_ragged_file_matches_reference(tmp_path,
                                                         both_native):
    """A path goes through the C++ loader in both packages, so labels,
    comments and sequences agree where the line parser would split the
    header on the first run of blanks and keep blanks in sequences."""
    path = str(tmp_path / "ragged.fa")
    with open(path, "w") as fh:
        fh.write(RAGGED_FASTA)
    with port_io.FastaReader(path) as p, ref_io.FastaReader(path) as r:
        got = [(s.label, s.comment, s.sequence) for s in p]
        want = [(s.label, s.comment, s.sequence) for s in r]
    assert got == want == [("a1", " two blanks here", "ACDEFGHIK"),
                           ("b2", "Tabbed comment", "MM"), ("c3", "", "PPQ")]
    assert native.read_fasta(path) == ref_native.read_fasta(path) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_native_read_fasta_matches_reference(seed, tmp_path, both_native):
    rng = np.random.default_rng(seed)
    path = str(tmp_path / "records.fa")
    with open(path, "w") as fh:
        for label, comment, seq in _fasta_records(rng):
            fh.write(f">{label}{' ' + comment if comment else ''}\r\n")
            for i in range(0, len(seq), 13):
                fh.write(seq[i: i + 13] + (" \t" if i % 2 else "") + "\n")
    assert native.read_fasta(path) == ref_native.read_fasta(path)
    with pytest.raises(FileNotFoundError):
        native.read_fasta(str(tmp_path / "missing.fa"))


def _compare_pair(seed):
    rng = np.random.default_rng(seed)
    old_raw = _rich_raw(seed)
    new_raw = json.loads(json.dumps(old_raw))
    for f in new_raw["features"]:
        r = rng.random()
        if r < 0.3:
            f["function"] = f"Renamed {f['function']}"
        elif r < 0.4:
            f["function"] = ""
        elif r < 0.5 and f.get("location"):
            f["location"][0][1] = str(int(f["location"][0][1]) + 3)
    new_raw["subsystems"] = new_raw["subsystems"][1:] + [
        {"name": "Brand new", "role_bindings": []}]
    return old_raw, new_raw


@pytest.mark.parametrize("seed", SEEDS)
def test_comparisons_match_reference(seed, tmp_path):
    old_raw, new_raw = _compare_pair(seed)
    got, want = [], []
    for module, gmod, out in ((compare, gto, got),
                              (ref_compare, ref_gto, want)):
        old, new = gmod.Genome(old_raw), gmod.Genome(new_raw)
        for kind in ("FUNCTIONS", "subsystems"):
            m = module.create_matcher(kind)
            out.append((m.compare(old, new), m.good, m.bad, m.percent()))
        with pytest.raises(ValueError):
            module.create_matcher("BOGUS")
        funcs = module.CompareFunctions()
        for a, b in ((new, old), (old, new)):
            out.append(funcs.compare(a, b))
        out.append([(f.id, f.name, funcs.get_match_count(f.id),
                     funcs.get_total_count(f.id),
                     sorted(funcs.get_miss_counts(f.id).items()),
                     [funcs.get_name(k) for k in funcs.get_miss_counts(f.id)])
                    for f in funcs.miss_functions()])
        other = gmod.Genome(json.loads(json.dumps(old_raw)))
        for c in other.contigs:
            c.raw["id"] = "elsewhere"
        out.append(module.CompareFunctions().compare(other, new))
    assert got == want
    assert got[0][1] > 0 and got[4]
    for i in range(3):
        gto.Genome(_rich_raw(i)).save(str(tmp_path / f"{i}.gto"))
    (tmp_path / "notes.txt").write_text("x")
    assert compare.md5_genome_map(str(tmp_path)) == (
        ref_compare.md5_genome_map(str(tmp_path)))


PROJECTOR = """\
# projector
SUBSYSTEM\tTranslation machinery core
CLASS\tProtein Processing\tTranslation
ROLE\tPhen\tPhenylalanyl-tRNA synthetase alpha chain
ROLE\tSery\tSeryl-tRNA synthetase
ROLE\tMiss\tSome role no genome has
RULE\tfull\tPhen and Sery and Miss
RULE\tactive\t2 of (Phen, Sery, Miss)
RULE\t0\tPhen or Sery or Miss
//
SUBSYSTEM\tHalf a machine
ROLE\tLsu\tLSU ribosomal protein L2p
RULE\t0\tLsu
//
SUBSYSTEM\tNegative control
ROLE\tPhen\tPhenylalanyl-tRNA synthetase alpha chain
ROLE\tMiss\tSome role no genome has
RULE\tactive\tPhen and not Miss
RULE\t-1\tnot Phen
//
"""


@pytest.mark.parametrize("seed", SEEDS)
def test_subsystem_projector_matches_reference(seed, tmp_path):
    path = tmp_path / "projector.tbl"
    path.write_text(PROJECTOR)
    port = subsystems.SubsystemRuleProjector.load(str(path))
    ref = ref_subsystems.SubsystemRuleProjector.load(str(path))
    raw = make_genome(f"30{seed}.1", seed=seed).raw
    for active_only in (True, False):
        got = gto.Genome(json.loads(json.dumps(raw)))
        want = ref_gto.Genome(json.loads(json.dumps(raw)))
        assert port.project(got, active_only=active_only) == ref.project(
            want, active_only=active_only)
        assert got.raw["subsystems"] == want.raw["subsystems"]
        assert got.raw["subsystems"]
    for text in ("A and (B or C)", "2 of (A, B, C and D)", "not A or D"):
        fp = subsystems._Parser(text, set("ABCD")).parse()
        fr = ref_subsystems._Parser(text, set("ABCD")).parse()
        for bits in range(16):
            present = {c for i, c in enumerate("ABCD") if bits >> i & 1}
            assert fp(present) == fr(present)
    bad = tmp_path / "bad.tbl"
    for text in ("SUBSYSTEM\tS\nROLE\tA\tRole A\nRULE\tx\tA and (B\n//\n",
                 "ROLE\tA\tRole A\n", "SUBSYSTEM\tS\nROLE\tA\tRole A\n//\n",
                 "SUBSYSTEM\tS\nWHAT\tA\n"):
        bad.write_text(text)
        for module in (subsystems, ref_subsystems):
            with pytest.raises(module.RuleError):
                module.SubsystemRuleProjector.load(str(bad))


# ---------------------------------------------------------------------------
# frames and location lists, quality counts, one-at-a-time proposals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_location_lists_match_reference(seed):
    rng = np.random.default_rng(seed)
    port_f, ref_f = locations.FramedLocationLists(), ref_loc.FramedLocationLists()
    port_l, ref_l = locations.SortedLocationList(), ref_loc.SortedLocationList()
    for _ in range(120):
        contig = f"c{int(rng.integers(0, 3))}"
        left = int(rng.integers(1, 300))
        right = left + int(rng.integers(0, 60))
        strand = str(rng.choice(["+", "-", "?"]))
        target = f"t{int(rng.integers(0, 4))}"
        p = locations.Location.create(contig, strand, left, right)
        r = ref_loc.Location.create(contig, strand, left, right)
        assert (p.frame, p.frame.idx, p.dir) == (r.frame, r.frame.idx, r.dir)
        port_f.connect(target, p)
        ref_f.connect(target, r)
        port_l.add(p)
        ref_l.add(r)
    assert [str(x) for x in port_l] == [str(x) for x in ref_l]
    assert (port_l.size(), len(port_l)) == (ref_l.size(), len(ref_l))
    for i in range(0, len(ref_l), 7):
        assert str(port_l.get(i)) == str(ref_l.get(i))
        assert [str(x) for x in port_l.contig_range(i)] == [
            str(x) for x in ref_l.contig_range(i)]
    assert port_f.size() == ref_f.size() == 120
    assert [(t, [str(x) for x in lst]) for t, lst in port_f] == [
        (t, [str(x) for x in lst]) for t, lst in ref_f]
    assert [f.name for f in locations.Frame] == [f.name for f in ref_loc.Frame]
    assert locations.N_FRAMES == ref_loc.N_FRAMES
    port_f.clear()
    assert port_f.size() == 0 and not list(port_f)


def test_genetic_code_starts_and_stops_match_reference():
    for gc in (1, 4, 11):
        port, ref = dna.GeneticCode.get(gc), ref_dna.GeneticCode.get(gc)
        for i in range(64):
            codon = "".join("tcag"[(i >> s) & 3] for s in (4, 2, 0))
            for c in (codon, codon.upper()):
                assert (port.is_start(c), port.is_stop(c)) == (
                    ref.is_start(c), ref.is_stop(c))


def test_quality_count_map_matches_reference():
    rng = np.random.default_rng(4)
    port, ref = counters.QualityCountMap(), ref_counters.QualityCountMap()
    for key, good in zip(rng.integers(0, 30, 400), rng.random(400) < 0.6):
        for m in (port, ref):
            (m.set_good if good else m.set_bad)(f"k{key}")
    assert port.all_keys() == ref.all_keys()
    for key in sorted(ref.all_keys()) + ["none"]:
        assert (port.good(key), port.bad(key)) == (ref.good(key),
                                                   ref.bad(key))
    assert [port.good(k) for k in port.best_keys()] == [
        ref.good(k) for k in ref.best_keys()]


def _proposal_view(p):
    return None if p is None else (str(p.loc), p.function, p.evidence)


@pytest.mark.parametrize("seed", SEEDS)
def test_one_at_a_time_proposals_match_reference(seed):
    """``PegProposalList.propose`` on seeded candidates, one at a time,
    against the reference's: what each call returns, the counters and the
    proposals in numbering order; and ``PegProposal.create``,
    ``Location.extend`` (against the reference's codon walker) and
    ``better_than``."""
    rng = np.random.default_rng(seed)
    new, _ = make_projection_pair(seed=seed, n_genes=6)
    raw = json.loads(json.dumps(new.raw))
    port_g, ref_g = gto.Genome(raw), ref_gto.Genome(raw)
    n = port_g.contigs[0].length
    port = proposals.PegProposalList(port_g, 0.05, 3)
    ref = ref_proposals.PegProposalList(ref_g, 0.05, 3)
    for i in range(400):
        contig = port_g.contigs[0].id if rng.random() > 0.03 else "missing"
        left = int(rng.integers(1, n - 30))
        right = left + 3 * int(rng.integers(1, 12)) - 1 - int(
            rng.random() < 0.05)
        strand = "+" if rng.random() < 0.5 else "-"
        evidence = int(rng.integers(1, 12))
        fn = f"role {int(rng.integers(0, 5))}"
        got = port.propose(locations.Location(contig, strand, left, right),
                           fn, evidence)
        want = ref.propose(ref_loc.Location(contig, strand, left, right),
                           fn, evidence)
        assert _proposal_view(got) == _proposal_view(want)
        made = proposals.PegProposal.create(
            port_g, locations.Location(contig, strand, left, right), fn,
            evidence)
        ref_made = ref_proposals.PegProposal.create(
            ref_g, ref_loc.Location(contig, strand, left, right), fn,
            evidence)
        assert _proposal_view(made) == _proposal_view(ref_made)
        ext = locations.Location(contig, strand, left, right).extend(port_g)
        ref_ext = ref_loc.Location(contig, strand, left, right).extend(ref_g)
        assert str(ext) == str(ref_ext)
    counts = ("made", "rejected", "weak", "small", "merged", "count")
    assert [getattr(port, c) for c in counts] == [
        getattr(ref, c) for c in counts]
    assert port.merged > 0 and port.count > 0 and port.rejected > 0
    assert [_proposal_view(p) for p in port] == [
        _proposal_view(p) for p in ref]
    stored = list(port)
    for a, b in zip(stored, stored[1:] + stored[:1]):
        ra = ref_proposals.PegProposal(ref_loc.Location(
            a.loc.contig_id, a.loc.strand, a.loc.left, a.loc.right),
            a.function, a.evidence)
        rb = ref_proposals.PegProposal(ref_loc.Location(
            b.loc.contig_id, b.loc.strand, b.loc.left, b.loc.right),
            b.function, b.evidence)
        assert a.better_than(b) == ra.better_than(rb)


# ---------------------------------------------------------------------------
# the C++ host library
# ---------------------------------------------------------------------------

def _proteins(seed, n=40):
    rng = np.random.default_rng(seed)
    return [_text(rng, "ACDEFGHIKLMNPQRSTVWYX*", int(rng.integers(0, 90)))
            for _ in range(n)]


_REF_NATIVE_RETRIED = []


def reference_native(settle_s: float = 1.0, wait_s: float = 120.0):
    """The reference's ``native`` module with its library loaded if it
    builds here.

    The reference builds ``libkan_host.so`` straight onto its final path,
    so where several test processes build it at once, one may open the
    file while another is still writing it ("file too short") and keep
    its library None for the rest of the run.  On such a failure this
    waits until the file has stopped changing (unchanged over
    ``settle_s``, at most ``wait_s``), then clears the module's load state
    once a process and loads again."""
    if ref_native.available() or _REF_NATIVE_RETRIED:
        return ref_native
    _REF_NATIVE_RETRIED.append(True)

    def state():
        try:
            st = os.stat(ref_native._SO)
        except FileNotFoundError:
            return None
        return st.st_size, st.st_mtime_ns

    deadline = time.monotonic() + wait_s
    last = state()
    while time.monotonic() < deadline:
        time.sleep(settle_s)
        now = state()
        if now == last:
            break
        last = now
    with ref_native._lock:
        ref_native._lib, ref_native._tried = None, False
    ref_native.available()
    return ref_native


@pytest.fixture(scope="module")
def both_native():
    if not (native.available() and reference_native().available()):
        pytest.skip("the C++ host library does not build here")


@pytest.mark.parametrize("seed", SEEDS)
def test_native_loaders_match_reference(seed, both_native):
    prots = _proteins(seed)
    total = sum(map(len, prots))
    for k in (5, 8, 12):
        got = native.row_batch(prots, k, len(prots) + 3, 96)
        want = ref_native.row_batch(prots, k, len(prots) + 3, 96)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        got = native.flat_batch(prots, k, total + 17, 9999)
        want = ref_native.flat_batch(prots, k, total + 17, 9999)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    got = native.flat_peg_batch(prots, total + 5, 777)
    want = ref_native.flat_peg_batch(prots, total + 5, 777)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", SEEDS)
def test_native_groupby_and_builder_match_reference(seed, both_native):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 50, 3000).astype(np.uint32)
    hi = rng.integers(0, 4, 3000).astype(np.uint32)
    got, want = native.groupby(lo, hi), ref_native.groupby(lo, hi)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    chunks = [(rng.integers(0, 2000, 800).astype(np.uint32),
               rng.integers(0, 3, 800).astype(np.uint32),
               rng.integers(0, 9, 800).astype(np.int32)) for _ in range(3)]
    kills = (rng.integers(0, 2000, 100).astype(np.uint32),
             rng.integers(0, 3, 100).astype(np.uint32))
    outs = []
    for make in (native.make_builder, ref_native.make_builder):
        b = make()
        for chunk in chunks:
            b.add_candidates(*chunk)
        b.add_kills(*kills)
        outs.append(b.finish())
        b.close()
    for g, w in zip(outs[0][:3], outs[1][:3]):
        np.testing.assert_array_equal(g, w)
    assert outs[0][3] == outs[1][3] and outs[0][3]["killed"] > 0


def test_native_baselines_match_reference(both_native):
    """The single-core baselines the chip smoke checks the port against:
    the packed-key apply walk, the projection hot loops and the
    string-keyed Java-dataflow apply walk."""
    from kmers_anno_tpu.ops.hashtable import build_table
    from kmers_anno_tpu_torch.ops.kmers import pack_kmers_np
    from kmers_anno_tpu_torch.ops.translate import codon_lut
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 20, (64, 60)).astype(np.uint8)
    lo, hi = pack_kmers_np(codes[:20].reshape(-1), 8)
    key = np.unique(hi.astype(np.int64) << 32 | lo)
    table, mp = build_table((key & 0xFFFFFFFF).astype(np.uint32),
                            (key >> 32).astype(np.uint32),
                            (np.arange(len(key)) % 7).astype(np.uint32))
    np.testing.assert_array_equal(
        native.apply_baseline(codes, table, mp, 8, 2),
        ref_native.apply_baseline(codes, table, mp, 8, 2))

    new, olds = make_projection_pair(seed=4, n_genes=6)
    contigs = [ref_enc.encode_dna(c.sequence) for c in new.contigs]
    lut = np.asarray(codon_lut(11), np.uint8)
    prots = [f.protein_translation for f in next(iter(olds.values())).pegs]
    got = native.ProjectionBaseline(contigs, lut, 8)
    want = ref_native.ProjectionBaseline(contigs, lut, 8)
    assert got.map_size() == want.map_size() > 0
    assert got.match(prots, 0.5, 1.5, 0.8) == want.match(prots, 0.5, 1.5,
                                                          0.8)
    got.close()
    want.close()

    kmers = sorted({p[i: i + 8] for p in prots for i in range(0, 40, 3)})
    role = np.arange(len(kmers), dtype=np.int32) % 5
    queries = prots + [p[::-1] for p in prots]
    assert np.array_equal(
        native.JavaDataflowBaseline(kmers, role, 8).apply(queries, 8, 2),
        ref_native.JavaDataflowBaseline(kmers, role, 8).apply(queries, 8, 2))


@pytest.mark.parametrize("seed", SEEDS)
def test_native_protein_encoder_matches_reference(seed, both_native):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 15, 700):
        s = _text(rng, "ACDEFGHIKLMNPQRSTVWYacdxXuU*-?", n)
        np.testing.assert_array_equal(native.encode_protein(s),
                                      ref_native.encode_protein(s))
        np.testing.assert_array_equal(native.encode_protein(s),
                                      encode.encode_protein(s))


@pytest.mark.parametrize("seed", [4, 7])
def test_native_java_projection_baseline_matches_reference(seed,
                                                           both_native):
    """The Java-dataflow projection loops: the contig map's size and the
    match counts equal the reference's, and the packed-key
    ``ProjectionBaseline``'s on the same pair."""
    from kmers_anno_tpu_torch.ops.translate import codon_lut
    new, olds = make_projection_pair(seed=seed, n_genes=6)
    contigs = [ref_enc.encode_dna(c.sequence) for c in new.contigs]
    lut = np.asarray(codon_lut(11), np.uint8)
    prots = [f.protein_translation for f in next(iter(olds.values())).pegs]
    got = native.JavaProjectionBaseline(contigs, lut, 8)
    want = ref_native.JavaProjectionBaseline(contigs, lut, 8)
    packed = native.ProjectionBaseline(contigs, lut, 8)
    assert got.map_size() == want.map_size() == packed.map_size() > 0
    for params in ((0.5, 1.5, 0.8), (0.9, 1.1, 1.0)):
        counts = got.match(prots, *params)
        assert counts == want.match(prots, *params) == packed.match(
            prots, *params)
    assert got.match(prots, 0.5, 1.5, 0.8)[0] > 0
    for handle in (got, want, packed):
        handle.close()


def test_native_hash_baseline_matches_reference(both_native):
    """The single-core hashAnno loop the chip smoke checks the engine
    against: kmer count, improvement events, best similarity and
    winner, over two batches of prototypes."""
    rng = np.random.default_rng(6)
    prots = [_text(rng, "ACDEFGHIKLMNPQRSTVWYX", int(rng.integers(5, 120)))
             for _ in range(40)]
    protos = [p[int(rng.integers(0, 5)):] for p in prots[::3]] + [
        _text(rng, "ACDEFGHIK", 60) for _ in range(5)]
    got = native.HashAnnoBaseline(prots, 8, 0.0125)
    want = ref_native.HashAnnoBaseline(prots, 8, 0.0125)
    assert got.n_kmers() == want.n_kmers() > 0
    for half in (protos[:7], protos[7:]):
        assert got.score(half) == want.score(half)
    for g, w in zip(got.best(), want.best()):
        np.testing.assert_array_equal(g, w)
    assert (got.best()[0] > 0).any()
    got.close()
    want.close()


def test_reference_native_retries_a_failed_load(monkeypatch):
    """A load that failed (as when another process was still writing the
    library) is retried once the file has settled."""
    if not reference_native().available():
        pytest.skip("the C++ host library does not build here")
    monkeypatch.setattr(ref_native, "_lib", None)
    monkeypatch.setattr(ref_native, "_tried", True)
    monkeypatch.setitem(globals(), "_REF_NATIVE_RETRIED", [])
    assert not ref_native.available()
    assert reference_native(settle_s=0.01).available()


@pytest.mark.parametrize("seed", SEEDS)
def test_native_dna_encoder_matches_reference(seed, both_native):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 15, 700):
        s = _text(rng, "acgtuACGTUnNryRYswkm-", n)
        np.testing.assert_array_equal(native.encode_dna(s),
                                      ref_native.encode_dna(s))
        np.testing.assert_array_equal(native.encode_dna(s),
                                      encode.encode_dna(s))


@pytest.mark.parametrize("k", [4, 8, 11, 15])
def test_native_dna_baseline_matches_reference(k, both_native):
    """The single-core DNA window probe the chip smoke checks the DNA
    kernel's hit count against, on a table whose walks wrap from the last
    bucket to bucket 0, over a stream with ambiguous bases."""
    from kmers_anno_tpu.ops.dna_kmers import pack_dna_np as ref_pack
    from kmers_anno_tpu.ops.hashtable import build_table as ref_build
    rng = np.random.default_rng(k)
    seq = rng.integers(0, 4, 3000).astype(np.uint8)
    lo, hi = ref_pack(seq, k)
    key = np.unique(lo)
    # 32 or more keys homed in the last two of 16 buckets: walks wrap
    last = (hashing.mix_kmer_np(key, np.zeros_like(key)) & 15) >= 14
    key = np.concatenate([key[last][: 40], key[~last][: 60]])
    table, mp = ref_build(key, np.zeros_like(key),
                          np.arange(len(key), dtype=np.uint32) % 9,
                          n_buckets=16)
    assert mp > 2
    codes = seq.copy()
    codes[rng.integers(0, len(codes), 40)] = 4
    got = native.dna_baseline(codes, table, mp, k)
    assert got == ref_native.dna_baseline(codes, table, mp, k) > 0


def test_native_builds_into_the_build_directory():
    """The library builds beside the CUDA kernels, in the gitignored
    ``_build`` directory, not beside its source."""
    if not native.available():
        pytest.skip("the C++ host library does not build here")
    assert native._SO.endswith(os.path.join("kmers_anno_tpu_torch",
                                            "_build", "libkan_host.so"))
    assert os.path.exists(native._SO)
