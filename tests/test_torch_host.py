"""The port's own host modules against the JAX package's originals.

The port keeps copies of the reference's jax-free host modules (GTO model,
locations, DNA translation, roles, codecs, hashing, ORF extension, tabular
readers, counters, apply reporters, the command table and the C++ host
library ``native``).  Each copy must give what the original gives on the
same inputs, made from a seed.
"""

import io
import json
import os
import time

import numpy as np
import pytest

from kmers_anno_tpu import native as ref_native
from kmers_anno_tpu.commands import app as ref_app
from kmers_anno_tpu.commands import base as ref_base
from kmers_anno_tpu.engine import annotation as ref_annotation
from kmers_anno_tpu.genome import dna as ref_dna
from kmers_anno_tpu.genome import gto as ref_gto
from kmers_anno_tpu.genome import locations as ref_loc
from kmers_anno_tpu.genome import roles as ref_roles
from kmers_anno_tpu.genome import sources as ref_sources
from kmers_anno_tpu.ops import encode as ref_enc
from kmers_anno_tpu.ops import hashing as ref_hashing
from kmers_anno_tpu.ops import orf as ref_orf
from kmers_anno_tpu.reports import apply_reports as ref_reports
from kmers_anno_tpu.utils import counters as ref_counters
from kmers_anno_tpu.utils import io as ref_io
from kmers_anno_tpu_torch import native
from kmers_anno_tpu_torch.commands import app, base
from kmers_anno_tpu_torch.engine import annotation
from kmers_anno_tpu_torch.genome import dna, gto, locations, roles, sources
from kmers_anno_tpu_torch.ops import encode, hashing, orf
from kmers_anno_tpu_torch.reports import apply_reports
from kmers_anno_tpu_torch.utils import counters
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
    assert [(name, desc) for name, (_, desc) in app.COMMANDS.items()] == [
        (name, desc) for name, (_, desc) in ref_app.COMMANDS.items()]
    assert {n for n, (f, _) in app.COMMANDS.items() if f} == {
        "kmers", "batch", "build", "apply", "hashAnno"}


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
