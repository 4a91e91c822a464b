"""The port's host-only commands against the JAX reference's, through both
CLIs: merge, seqCheck, genes, compare, funMap, funApply (with and without
``--project``), updateJson, buildGtos and the applyAnno / checkAnno /
listAnno trio.

Every case writes its inputs once, made with ``tests/fixtures.make_genome``
from fixed seeds, copies them into one directory a package and runs the
same command lines in each, from that directory.  The exit codes, the
standard output of every command and every file of the two directories
(inputs rewritten in place, GTOs, reports) must be equal byte for byte:
the tolerance is 0.  The anno trio reads ``.anno.tbl`` files that the
port's own ``hashAnno --device cpu`` wrote.
"""

import copy
import json
import os
import random
import shutil

import pytest
import torch

from kmers_anno_tpu.commands.app import main as ref_main
from kmers_anno_tpu.genome.gto import Genome
from kmers_anno_tpu.genome.roles import role_checksum
from kmers_anno_tpu_torch.commands.app import main as port_main
from tests.fixtures import ROLE_DEFS, make_genome, random_protein

MAINS = {"ref": ref_main, "port": port_main}

PROJECTOR = """\
SUBSYSTEM\tTranslation machinery core
CLASS\tProtein Processing\tTranslation
ROLE\tPhen\tPhenylalanyl-tRNA synthetase alpha chain
ROLE\tSery\tSeryl-tRNA synthetase
ROLE\tMiss\tSome role no genome has
RULE\tfull\tPhen and Sery and Miss
RULE\tactive\t2 of (Phen, Sery, Miss)
RULE\t0\tPhen or Sery or Miss
//
SUBSYSTEM\tWidget system
CLASS\tMiscellaneous
ROLE\tWid\tBrand new projected role
RULE\tactive\tWid
//
SUBSYSTEM\tNegative control
ROLE\tPhen\tPhenylalanyl-tRNA synthetase alpha chain
ROLE\tMiss\tSome role no genome has
RULE\tactive\tPhen and not Miss
//
"""


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module's tests run (the suite runs
    in several worker processes; see test_torch_mesh.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(root) -> dict:
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


def run_both(tmp_path, monkeypatch, capsys, steps) -> dict:
    """Run ``steps`` (command lines with paths relative to the inputs) in
    a copy of ``tmp_path/inputs`` for each package; both must give the
    same exit codes, standard output and files.  Returns the reference's
    (exit codes, outputs, files)."""
    monkeypatch.setenv("KMERS_ANNO_LOG", "off")
    capsys.readouterr()
    got = {}
    for name, main in MAINS.items():
        root = tmp_path / name
        shutil.copytree(tmp_path / "inputs", root)
        monkeypatch.chdir(root)
        rcs, outs = [], []
        for argv in steps:
            rcs.append(main(list(argv)))
            outs.append(capsys.readouterr().out)
        got[name] = (rcs, outs, _tree(root))
    monkeypatch.chdir(tmp_path)
    assert got["port"][0] == got["ref"][0]
    assert got["port"][1] == got["ref"][1]
    assert sorted(got["port"][2]) == sorted(got["ref"][2])
    for path, data in got["ref"][2].items():
        assert got["port"][2][path] == data, path
    return got["ref"]


def _save(genome, directory):
    os.makedirs(directory, exist_ok=True)
    genome.save(os.path.join(str(directory), f"{genome.id}.gto"))


def _write_roles(path):
    with open(path, "w") as fh:
        for rid, name in ROLE_DEFS:
            fh.write(f"{rid}\t{role_checksum(name)}\t{name}\n")


def rich_genome(gid: str, seed: int) -> Genome:
    """``make_genome`` with aliases of several kinds, two pegs with no
    function (hypothetical), a peg under a projector role and subsystem
    rows, one of which binds a feature that another row binds too."""
    g = make_genome(gid, seed=seed)
    pegs = g.pegs
    pegs[0].add_alias("gene_name", f"ab{seed}A")
    pegs[0].add_alias("LocusTag", f"LT_{seed}_1")
    pegs[2].raw["aliases"] = [f"bare{seed}", ["gene_name", f"cd{seed}B"]]
    pegs[3].function = ""
    pegs[7].function = "hypothetical protein"
    pegs[5].function = "Brand new projected role"
    g.raw["subsystems"] = [
        {"name": "Test subsystem", "variant_code": "active",
         "classification": ["Metabolism", "Energy"],
         "role_bindings": [{"role_id": pegs[0].function,
                            "features": [pegs[0].id, pegs[1].id]}]},
        {"name": "Second subsystem", "variant_code": "-1",
         "classification": ["Metabolism", "Energy", "Fine", "Extra"],
         "role_bindings": [{"role_id": pegs[1].function,
                            "features": [pegs[1].id]},
                           {"role_id": "Hypothetical",
                            "features": [pegs[3].id]}]}]
    return Genome(g.raw)


# ---------------------------------------------------------------------------
# the cases of tests/test_commands.py, and more of each command's options
# ---------------------------------------------------------------------------

def setup_merge(inputs):
    d = inputs / "eval"
    d.mkdir()
    (d / "roles.to.use").write_text("R1\nR2\nR3\nR4\n")
    (d / "training.tbl").write_text(
        "genome\tR1\tR2\tR3\tR4\n100.1\t1\t2\t3\t0\n100.2\t4\t5\t6\t1\n")
    (d / "testing.tbl").write_text(
        "200.1\t7\t0\t9\t0\n200.2\t1\t0\t0\t0\n200.3\t0\t0\t2\t0\n")
    return [["merge", "eval"]]


def setup_seq_check(inputs):
    genomes = [rich_genome(f"60{i}.1", seed=11 + i) for i in range(3)]
    g0, g1, g2 = genomes
    g0.pegs[1].protein_translation = g0.pegs[0].protein_translation
    g0.pegs[1].function = "a different story"
    g1.pegs[4].protein_translation = g0.pegs[0].protein_translation
    g2.pegs[6].protein_translation = g1.pegs[6].protein_translation
    g2.pegs[6].function = g1.pegs[6].function.upper()  # same normalized
    g2.pegs[8].protein_translation = g0.pegs[8].protein_translation.lower()
    for g in genomes:
        _save(g, inputs / "gtos")
    _write_roles(inputs / "roles.in.subsystems")
    return [["seqCheck", "gtos"],
            ["seqCheck", "--roles", "roles.in.subsystems", "-o",
             "check.tbl", "gtos"]]


def setup_genes(inputs):
    source = rich_genome("610.1", seed=21)
    target = copy.deepcopy(source)
    for i, f in enumerate(source.pegs):
        f.add_alias("gene_name", f"gn{i}")
    for f in target.pegs:
        f.raw["aliases"] = []
    # a shortened protein stays within the distance, a new one does not
    target.pegs[1].protein_translation = (
        target.pegs[1].protein_translation[4:])
    target.pegs[2].protein_translation = random_protein(random.Random(5),
                                                        90)
    source.save(str(inputs / "source.gto"))
    target.save(str(inputs / "target.gto"))
    return [["genes", "source.gto", "target.gto", "out.gto"],
            ["genes", "-m", "0.05", "-K", "5", "source.gto", "target.gto",
             "out2.gto"]]


def _compare_inputs(inputs):
    old = rich_genome("620.1", seed=31)
    new = copy.deepcopy(old)
    for f in new.pegs[:3]:
        f.function = "Renamed " + f.function
    new.pegs[4].function = new.pegs[5].function
    new.raw["subsystems"] = new.raw["subsystems"][:1] + [
        {"name": "Only new", "variant_code": "active",
         "role_bindings": []}]
    new2 = copy.deepcopy(old)
    new2.pegs[6].function = ""
    # a genome matching no reference genome
    other = rich_genome("621.1", seed=32)
    other.raw["contigs"][0]["dna"] = "ggcc" * 100
    _save(old, inputs / "old")
    _save(new, inputs / "new")
    _save(other, inputs / "new")
    _save(new2, inputs / "new2")
    _write_roles(inputs / "roles.in.subsystems")


def setup_compare(inputs):
    _compare_inputs(inputs)
    return [["compare", "old", "new", "new2"],
            ["compare", "-t", "SUBSYSTEMS", "-o", "subs.tbl", "old", "new"]]


def setup_fun_map(inputs):
    _compare_inputs(inputs)
    return [["funMap", "old", "new"],
            ["funMap", "--roles", "roles.in.subsystems", "-o", "map.tbl",
             "old", "new2"]]


def _fun_apply_inputs(inputs):
    for i in range(2):
        _save(rich_genome(f"63{i}.1", seed=41 + i), inputs / "in")
    target_fn = ROLE_DEFS[1][1]
    (inputs / "mapping.tbl").write_text(
        "patric_function\tcore_function\tgood\n"
        f"{target_fn}\tBrand new core function\tY\n"
        "totally unknown widget\tBrand new projected role\tyes\n"
        f"{ROLE_DEFS[3][1]}\t{ROLE_DEFS[3][1].upper()}\tY\n"
        "something else\tignored\t\n")


def setup_fun_apply(inputs):
    _fun_apply_inputs(inputs)
    return [["funApply", "mapping.tbl", "in", "out"]]


def setup_fun_apply_project(inputs):
    _fun_apply_inputs(inputs)
    (inputs / "projector.tbl").write_text(PROJECTOR)
    return [["funApply", "--project", "projector.tbl", "mapping.tbl", "in",
             "out"]]


def setup_fun_apply_bad_projector(inputs):
    _fun_apply_inputs(inputs)
    (inputs / "bad.tbl").write_text("SUBSYSTEM\tBroken\nROLE\tA\tRole A\n"
                                    "RULE\tactive\tA and (B\n//\n")
    return [["funApply", "--project", "bad.tbl", "mapping.tbl", "in",
             "out"]]


def setup_update_json(inputs):
    g = rich_genome("640.1", seed=51)
    _save(g, inputs / "gtos")
    gdir = inputs / "json_in" / g.id
    gdir.mkdir(parents=True)
    feats = [{"patric_id": f.id, "product": "old product",
              "genome_id": g.id, "start": "1", "end": 10, "public": "yes",
              "segments": "x", "aa_length": None}
             for f in g.pegs[:4]]
    feats.append({"patric_id": "fig|640.1.peg.999", "product": "gone"})
    feats.append({"product": "no id"})
    (gdir / "genome_feature.json").write_text(json.dumps(feats))
    (gdir / "genome.json").write_text(json.dumps([{"genome_id": g.id}]))
    (gdir / "sp_gene.json").write_text("[]")
    _write_roles(inputs / "roles.in.subsystems")
    return [["updateJson", "-R", "roles.in.subsystems", "json_in", "gtos",
             "json_out"]]


def setup_build_gtos(inputs):
    genomes = [rich_genome(f"65{i}.1", seed=61 + i) for i in range(2)]
    for g in genomes:
        _save(g, inputs / "gtos_in")
    p0, p1 = genomes[0].pegs, genomes[1].pegs
    d = inputs / "annofiles"
    d.mkdir()
    (d / "calls").write_text(
        f"{p0[0].id}\tCalled function one\t\t\n"
        f"{p0[1].id}\tCalled function two\t\t\n"
        f"{p1[2].id}\tCalled function three\t\t\n"
        "fig|9999.9.peg.1\tbogus\t\t\n")
    (d / "local.family.defs").write_text(
        "17\tFamily function seventeen\t\t\t\t\n"
        "3\tFamily function three\t\t\t\t\n")
    (d / "local.family.members.expanded").write_text(
        f"17\t{p0[1].id}\tx\tx\tgenA\n"
        f"3\t{p1[2].id}\tx\tx\t \n"
        f"42\t{p1[3].id}\tx\tx\tgenC\n"
        "17\tfig|9999.9.peg.2\tx\tx\tgenD\n")
    return [["buildGtos", "-D", "gtos_out", "-t", "DIR", "1234", "annofiles",
             "gtos_in"]]


# ---------------------------------------------------------------------------
# the anno trio: the flow of test_hashanno.py's CLI test and the target
# cases of test_round3_gaps.py
# ---------------------------------------------------------------------------

def _hash_anno_inputs(inputs):
    """Two rich genomes and the port's ``hashAnno --device cpu`` output
    for them: some annotations confirmed, some changed, hypothetical
    pegs renamed, the rest defaulted."""
    genomes = [rich_genome(f"66{i}.1", seed=71 + i) for i in range(2)]
    for g in genomes:
        _save(g, inputs / "gtos")
    pegs = [f for f in genomes[0].pegs if f.protein_translation]
    with open(inputs / "annos.tbl", "w") as fh:
        fh.write("protein\tannotation\n")
        fh.write(f"{pegs[0].protein_translation}\t{pegs[0].peg_function}\n")
        fh.write(f"{pegs[1].protein_translation}\tShiny new function\n")
        fh.write(f"{pegs[3].protein_translation}\tNo longer hypothetical\n")
        fh.write(f"{pegs[7].protein_translation[2:]}\tA fragment role\n")
        fh.write(f"{genomes[1].pegs[9].protein_translation}\tOther role\n")
    assert port_main(["hashAnno", "--device", "cpu", "-K", "8", "--minLen",
                      "10", "-D", str(inputs / "Annotations"),
                      str(inputs / "annos.tbl"), str(inputs / "gtos")]) == 0
    names = sorted(os.listdir(inputs / "Annotations"))
    assert names == ["660.1.anno.tbl", "661.1.anno.tbl", "changes.tbl"]


def setup_anno_trio(inputs):
    _hash_anno_inputs(inputs)
    return [["applyAnno", "Annotations", "gtos", "out_gtos"],
            ["checkAnno", "Annotations"],
            ["checkAnno", "-m", "0.5", "-o", "check.tbl", "Annotations"],
            ["listAnno", "gtos", "out_gtos"],
            ["listAnno", "--format", "NEW_ROLES", "-o", "new_roles.tbl",
             "gtos", "out_gtos"],
            ["listAnno", "-o", "back.tbl", "out_gtos", "gtos"]]


def _round3_inputs(inputs):
    """One genome dir and one anno dir renaming its second peg and a
    feature the genome lacks (test_round3_gaps.py's set-up)."""
    g = make_genome("100.1", seed=7)
    _save(g, inputs / "gtos")
    (inputs / "annos").mkdir()
    pegs = [f for f in g.pegs if f.protein_translation]
    with open(inputs / "annos" / "100.1.anno.tbl", "w") as fh:
        fh.write("fid\tscore\tnew_annotation\told_annotation\n")
        fh.write(f"{pegs[1].id}\t0.95\tShiny new function\t"
                 f"{pegs[1].peg_function}\n")
        fh.write("fig|100.1.peg.999\t0.5\tNowhere\tNothing\n")


def setup_apply_anno_list(inputs):
    _round3_inputs(inputs)
    step = ["applyAnno", "--target", "LIST", "annos", "gtos",
            "genomes.list"]
    return [step, step, step[:1] + ["--clear"] + step[1:], step]


def setup_apply_anno_dnafasta(inputs):
    _round3_inputs(inputs)
    return [["applyAnno", "--target", "DNAFASTA", "--clear", "annos",
             "gtos", "genomes.fna"],
            ["applyAnno", "--target", "dnafasta", "annos", "gtos",
             "genomes.fna"]]


def setup_apply_anno_bad_target(inputs):
    _round3_inputs(inputs)
    return [["applyAnno", "--target", "BOGUS", "annos", "gtos", "x"]]


def setup_check_anno_scores(inputs):
    """checkAnno's statistics at the edges of Java's Double.toString:
    empty and zero scores, scores whose means print in exponent form,
    integral means, one-value columns (deviation 0.0) and an empty
    column (NaN)."""
    d = inputs / "annos"
    d.mkdir()
    rows = {
        "700.1": [("a", "", "x", "hypothetical protein"),
                  ("b", "0.0", "y", "y"),
                  ("c", "0.0001", "z", "z"),
                  ("d", "0.00015", "w", "w"),
                  ("e", "12345678.5", "q", "r"),
                  ("f", "nonsense", "hypothetical protein", "s")],
        "700.2": [("g", "1.0", "m", "m"), ("h", "3.0", "n", "n"),
                  ("i", "0.001", "o", "p")],
        "700.3": [("j", "0.25", "keep", "me")],
        "700.4": [("k", "20000000.0", "a", "a"), ("l", "30000000", "b", "b"),
                  ("m", "-0.0", "c", "d")],
        "700.5": [("n", "0.0002", "e", "e"), ("o", "1e-300", "f", "g"),
                  ("p", "nan", "h", "h")],
    }
    for gid, lines in rows.items():
        with open(d / f"{gid}.anno.tbl", "w") as fh:
            fh.write("fid\tscore\tnew_annotation\told_annotation\n")
            fh.writelines(f"fig|{gid}.peg.{fid}\t{s}\t{new}\t{old}\n"
                          for fid, s, new, old in lines)
    with open(d / "changes.tbl", "w") as fh:
        fh.write("fid\tscore\tnew_annotation\told_annotation\n")
        fh.write("x\t0.95\tq\tr\n")
        fh.write("x\t0.2\to\tp\n")
        fh.write("x\t0.99\tme\tkeep\n")
    return [["checkAnno", "annos"], ["checkAnno", "-m", "0.1", "annos"],
            ["checkAnno", "-m", "1.5", "annos"]]


CASES = {
    "merge": setup_merge,
    "seq_check": setup_seq_check,
    "genes": setup_genes,
    "compare": setup_compare,
    "fun_map": setup_fun_map,
    "fun_apply": setup_fun_apply,
    "fun_apply_project": setup_fun_apply_project,
    "fun_apply_bad_projector": setup_fun_apply_bad_projector,
    "update_json": setup_update_json,
    "build_gtos": setup_build_gtos,
    "anno_trio": setup_anno_trio,
    "apply_anno_list": setup_apply_anno_list,
    "apply_anno_dnafasta": setup_apply_anno_dnafasta,
    "apply_anno_bad_target": setup_apply_anno_bad_target,
    "check_anno_scores": setup_check_anno_scores,
}

# what each case must show besides the two packages agreeing, so that an
# agreement on nothing (both failing, both writing nothing) cannot pass
EXPECTED_RCS = {"fun_apply_bad_projector": [2],
                "apply_anno_bad_target": [2],
                "check_anno_scores": [0, 0, 2]}


@pytest.mark.parametrize("case", sorted(CASES))
def test_command_matches_reference(case, tmp_path, monkeypatch, capsys):
    inputs = tmp_path / "inputs"
    inputs.mkdir()
    steps = CASES[case](inputs)
    rcs, outs, files = run_both(tmp_path, monkeypatch, capsys, steps)
    assert rcs == EXPECTED_RCS.get(case, [0] * len(steps))
    written = {p for p in files
               if not os.path.exists(os.path.join(inputs, p))
               or open(os.path.join(inputs, p), "rb").read() != files[p]}
    assert written or any(outs) or case in EXPECTED_RCS


# ---------------------------------------------------------------------------
# chip_smoke.py's commands phase, rehearsed on the CPU at a small size
# ---------------------------------------------------------------------------

def test_chip_smoke_commands_phase_on_cpu(tmp_path, monkeypatch):
    """The smoke's ``commands`` phase on what the port's own ``kmers`` and
    ``hashAnno`` write with ``--device cpu``: 24 planted genes and two
    close genomes, and two signature genomes with a small annotation
    file.  Every recount of the phase must hold."""
    import numpy as np

    import chip_smoke as smoke

    monkeypatch.setenv("KMERS_ANNO_LOG", "off")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    proj = tmp_path / "proj"
    (proj / "cache").mkdir(parents=True)
    planted: list = []
    _, olds, new = smoke.make_projection_workload(
        np.random.default_rng(3), 24, 2, planted=planted)
    for gid, og in olds.items():
        og.save(str(proj / "cache" / f"{gid}.gto"))
    new.save(str(proj / "new.gto"))
    smoke.write_planted(str(proj), planted, next(iter(olds.values())))
    assert port_main(["kmers", "--device", "cpu", "--cache",
                      str(proj / "cache"), "-i", str(proj / "new.gto"),
                      "-o", str(proj / "out.gto")]) == 0

    genomes, _ = smoke.make_signature_genomes(
        np.random.default_rng(4), 2, 30, 20, 3, plen=60)
    for g in genomes:
        g.features[3].function = ""
        _save(g, tmp_path / "gtos")
    pegs = [f for g in genomes for f in g.pegs]
    with open(tmp_path / "annos.tbl", "w") as fh:
        fh.write("protein\tannotation\n")
        for i, f in enumerate(pegs[:40]):
            new_fn = f.function if i % 4 == 0 else f"Hash role {i}"
            fh.write(f"{f.protein_translation[(i % 5) * 6:]}\t{new_fn}\n")
    assert port_main(["hashAnno", "--device", "cpu", "-D",
                      str(tmp_path / "hash"), str(tmp_path / "annos.tbl"),
                      str(tmp_path / "gtos")]) == 0
    (tmp_path / "phase").mkdir()
    smoke.run_commands(str(tmp_path / "phase"), str(tmp_path / "hash"),
                       str(tmp_path / "gtos"), str(proj))
