"""The port's mesh (``parallel.mesh``, ``engine.mesh_apply``) against the
JAX reference on the CPU.

The reference runs on the 8 virtual CPU devices of tests/conftest.py, the
port on as many virtual CPU members.  Host functions are byte-equal;
each apply step equals the reference's step on the same seeded inputs
(tolerance 0, weighted tallies aside: rtol 1e-5 against the reference's
float32 psum, bit-equal against the port's single-device vote); the DNA
probe steps' payloads are exact; and the engines equal both the port's
single-device engines and the reference's mesh engine over the shapes of
``tests/test_mesh_apply.py`` and ``tests/test_compose_matrix.py``.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmers_anno_tpu.engine import mesh_apply as ref_engine
from kmers_anno_tpu.engine import signature as ref_sig
from kmers_anno_tpu.parallel import mesh as ref_mesh
from kmers_anno_tpu_torch.engine import mesh_apply as port_engine
from kmers_anno_tpu_torch.engine import signature as port_sig
from kmers_anno_tpu_torch.engine.apply_engine import FlatBatch, KmerApplyEngine
from kmers_anno_tpu_torch.engine.dna_apply import (DnaApplyEngine,
                                                   DnaContigBatch)
from kmers_anno_tpu_torch.ops.apply_flat import apply_weighted_flat_plain
from kmers_anno_tpu_torch.ops.encode import PROT_PAD
from kmers_anno_tpu_torch.ops.hashtable import build_table
from kmers_anno_tpu_torch.ops.probe_keys import probe_keys
from kmers_anno_tpu_torch.parallel import mesh as port_mesh
from tests.fixtures import ROLE_DEFS, make_genome, make_role_map
from tests.test_dna_mode import make_dna_genome

K = 8
GOOD = {rid for rid, _ in ROLE_DEFS[:4]}
N_GENOMES = 6   # not divisible by any data-axis size of the shapes below
CPU = torch.device("cpu")
SHAPES = [(8, 1, "auto"), (4, 2, "auto"), (4, 2, "pmax"), (2, 4, "routed"),
          (1, 8, "routed")]


def members(n):
    return [CPU] * n


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module's tests run.  Their tensors
    are small, and the suite runs in several worker processes: with a
    thread a core in each, the workers' threads outnumber the cores and
    every torch op waits on descheduled threads (several times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def genomes():
    return [make_genome(f"300{i}.1", seed=500 + i) for i in range(N_GENOMES)]


@pytest.fixture(scope="module")
def tables(genomes):
    """(port table, reference table) of the same keys, unweighted and
    with 'balance' weights."""
    out = {}
    for mode in ("none", "balance"):
        kw = dict(k=K, progress=False, weight_mode=mode)
        out[mode] = (port_sig.build_signatures(genomes, make_role_map(), GOOD,
                                               device="cpu", **kw),
                     ref_sig.build_signatures(genomes, make_role_map(), GOOD,
                                              **kw))
    return out


def _calls(engine, genomes):
    return [[(f.id, role, hits) for f, role, hits in calls]
            for _, calls in engine.call_genomes(genomes)]


# ---------------------------------------------------------------------------
# host functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["4x2", "8", "2X4", "3×5", "axb", "1x2x3",
                                  "4y2", ""])
def test_parse_mesh_spec_matches_reference(spec):
    try:
        want = ref_engine.parse_mesh_spec(spec)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            port_engine.parse_mesh_spec(spec)
        assert str(got.value) == str(exc)
    else:
        assert port_engine.parse_mesh_spec(spec) == want


def test_make_mesh_counts_members():
    with pytest.raises(ValueError, match="need 8 devices, have 3"):
        port_mesh.make_mesh(4, 2, members(3))
    mesh = port_mesh.make_mesh(2, 2, members(5), processes=[0, 0, 1, 1, 1])
    assert mesh.shape == {"data": 2, "table": 2}
    assert mesh.devices == [[CPU, CPU], [CPU, CPU]]
    assert mesh.processes == [[0, 0], [1, 1]]


@pytest.mark.parametrize("n_table", [2, 4])
@pytest.mark.parametrize("weights", ["none", "balance"])
def test_shard_signature_table_matches_reference(tables, n_table, weights):
    port, _ = tables[weights]
    values = port._payloads(weights != "none")
    got, got_mp = port_mesh.shard_signature_table(port.key_lo, port.key_hi,
                                                  values, n_table)
    want, want_mp = ref_mesh.shard_signature_table(port.key_lo, port.key_hi,
                                                   values, n_table)
    assert got.dtype == want.dtype == np.uint32
    assert got.tobytes() == want.tobytes() and got_mp == want_mp


@pytest.mark.parametrize("n_table", [2, 3, 4])
@pytest.mark.parametrize("length", [1, 97, 1000])
def test_split_tokens_matches_reference(n_table, length):
    rng = np.random.default_rng(length + n_table)
    codes = rng.integers(0, 25, length).astype(np.uint8)
    seg = np.sort(rng.integers(0, 9, length)).astype(np.int32)
    valid = rng.random(length) < 0.8
    got = port_mesh.split_tokens_for_table_axis(codes, seg, valid, n_table, K,
                                                12, PROT_PAD)
    want = ref_mesh.split_tokens_for_table_axis(codes, seg, valid, n_table, K,
                                                12, PROT_PAD)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_route_keys_ranks_each_owner_in_stream_order():
    """A member's routing buffers: each owner's keys in stream order, the
    empty slots EMPTY with segment n_seqs, and a capacity short by one
    sets the flag."""
    from kmers_anno_tpu_torch.ops.hashing import mix_kmer
    from kmers_anno_tpu_torch.ops.kmers import pack_kmer_windows

    rng = np.random.default_rng(5)
    codes = torch.from_numpy(rng.integers(0, 20, 400).astype(np.uint8))
    seg = torch.arange(400, dtype=torch.int32) // 40
    valid = torch.from_numpy(rng.random(400) < 0.9)
    lo, hi = pack_kmer_windows(codes, K)
    owner = mix_kmer(lo, hi) % 3
    most = max(int((valid & (owner == s)).sum()) for s in range(3))
    blo, bhi, bseg, ovf, _ = port_mesh.route_keys(
        codes, seg, valid, k=K, n_table=3, capacity=most, n_seqs=10)
    assert not bool(ovf)
    for s in range(3):
        mine = valid & (owner == s)
        n = int(mine.sum())
        assert torch.equal(blo[s, :n], lo[mine])
        assert torch.equal(bhi[s, :n], hi[mine])
        assert torch.equal(bseg[s, :n], seg[mine])
        assert (blo[s, n:] == -1).all() and (bseg[s, n:] == 10).all()
    *_, ovf, _ = port_mesh.route_keys(codes, seg, valid, k=K, n_table=3,
                                      capacity=most - 1, n_seqs=10)
    assert bool(ovf)


@pytest.mark.parametrize("short", [0, 1])
def test_route_keys_counts_each_owners_live_keys(short):
    """``live[s]`` is owner s's key count cut to the capacity: the length
    of the live prefix of its bucket, EMPTY past it; at a capacity that
    fits, and at one short by one, where the fullest owner's count is cut
    and the flag is set."""
    from kmers_anno_tpu_torch.ops.hashing import mix_kmer
    from kmers_anno_tpu_torch.ops.kmers import pack_kmer_windows

    rng = np.random.default_rng(6)
    codes = torch.from_numpy(rng.integers(0, 20, 500).astype(np.uint8))
    seg = torch.arange(500, dtype=torch.int32) // 50
    valid = torch.from_numpy(rng.random(500) < 0.8)
    lo, hi = pack_kmer_windows(codes, K)
    owner = mix_kmer(lo, hi) % 4
    count = [int((valid & (owner == s)).sum()) for s in range(4)]
    cap = max(count) - short
    blo, _, bseg, ovf, live = port_mesh.route_keys(
        codes, seg, valid, k=K, n_table=4, capacity=cap, n_seqs=10)
    assert live.dtype == torch.int64
    assert live.tolist() == [min(c, cap) for c in count]
    assert bool(ovf) == bool(short)
    for s in range(4):
        n = int(live[s])
        assert (blo[s, :n] != -1).all() and (blo[s, n:] == -1).all()
        assert (bseg[s, :n] < 10).all() and (bseg[s, n:] == 10).all()


# ---------------------------------------------------------------------------
# the steps against the reference's steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def streams(genomes):
    """Four genomes' flat token streams, one a data row, one bucketed
    shape (as tests/test_parallel.py lays them out)."""
    prots = [[f.protein_translation for f in g.pegs if f.protein_translation]
             for g in genomes[:4]]
    width = max(FlatBatch(p, K).codes.size for p in prots)
    n_seqs = max(FlatBatch(p, K).n_seqs for p in prots)
    batches = [FlatBatch(p, K, min_tokens=width, min_seqs=n_seqs)
               for p in prots]
    return (np.stack([b.codes for b in batches]),
            np.stack([b.seg_ids for b in batches]),
            np.stack([b.valid for b in batches]), n_seqs)


def _first_rows(streams, n_data):
    """The first n_data rows of the streams, the four genomes repeated."""
    *arrays, n_seqs = streams
    return (*(np.concatenate([a, a])[:n_data] for a in arrays), n_seqs)


def _tables(table, weighted, n_table):
    payloads = table._payloads(weighted)
    if n_table == 1:
        host, mp = build_table(table.key_lo, table.key_hi, payloads)
        return host[None], mp
    return port_mesh.shard_signature_table(table.key_lo, table.key_hi,
                                           payloads, n_table)


def _port_step(kind, table, weighted, n_data, n_table, n_seqs, **kw):
    host, mp = _tables(table, weighted, 1 if kind == "replicated"
                       else n_table)
    mesh = port_mesh.make_mesh(n_data, n_table, members(n_data * n_table))
    placed = port_mesh.MemberTables(mesh, host, range(n_data),
                                    kind != "replicated")
    build = {"replicated": port_mesh.replicated_apply_step,
             "pmax": port_mesh.sharded_apply_step,
             "routed": port_mesh.routed_apply_step}[kind]
    step = build(mesh, k=K, max_probes=mp, n_seqs=n_seqs, weighted=weighted,
                 n_roles=len(table.role_ids), **kw)
    return (lambda *a: step(placed, *a)), host, mp


def _ref_step(kind, host, mp, table, weighted, n_data, n_table, n_seqs,
              **kw):
    mesh = ref_mesh.make_mesh(n_data, n_table)
    build = {"replicated": ref_mesh.replicated_apply_step,
             "pmax": ref_mesh.sharded_apply_step,
             "routed": ref_mesh.routed_apply_step}[kind]
    step = build(mesh, k=K, max_probes=mp, n_seqs=n_seqs, weighted=weighted,
                 n_roles=len(table.role_ids), **kw)
    ref_table = jnp.asarray(host[0] if kind == "replicated" else host)
    return lambda *a: [np.asarray(x) for x in step(ref_table, *a)]


def _routed_inputs(codes, seg_ids, valid, n_table, n_seqs):
    rows = [port_mesh.split_tokens_for_table_axis(
        codes[i], seg_ids[i], valid[i], n_table, K, n_seqs, PROT_PAD)
        for i in range(codes.shape[0])]
    return [np.stack([r[w] for r in rows]) for w in range(3)]


def _single_device_weighted(table, codes, seg_ids, valid, n_seqs, thresh):
    """The port's single-device weighted vote of each row."""
    host, mp = build_table(table.key_lo, table.key_hi, table._payloads(True))
    t = torch.from_numpy(host.view(np.int32))
    out = [apply_weighted_flat_plain(
        t, *(torch.from_numpy(a[i]) for a in (codes, seg_ids, valid)),
        thresh, k=K, max_probes=mp, n_seqs=n_seqs,
        n_roles=len(table.role_ids)) for i in range(codes.shape[0])]
    return (torch.stack([o[0] for o in out]).numpy(),
            torch.stack([o[1] for o in out]).numpy())


def _check_weighted(got, want_ref, want_port):
    roles, tally = (np.asarray(g) for g in got[:2])
    assert np.array_equal(roles, want_ref[0])
    np.testing.assert_allclose(tally, want_ref[1], rtol=1e-5)
    assert np.array_equal(roles, want_port[0])
    assert tally.view(np.int32).tobytes() == want_port[1].view(
        np.int32).tobytes()
    assert (roles >= 0).any()


@pytest.mark.parametrize("kind,n_table", [("replicated", 2), ("pmax", 2),
                                          ("pmax", 4)])
@pytest.mark.parametrize("weights", ["none", "balance"])
def test_broadcast_steps_match_reference(tables, streams, kind, n_table,
                                         weights):
    n_data = 8 // n_table
    codes, seg_ids, valid, n_seqs = _first_rows(streams, n_data)
    table = tables[weights][0]
    weighted = weights != "none"
    thresh = 0.5 if weighted else 1
    port, host, mp = _port_step(kind, table, weighted, n_data, n_table,
                                n_seqs)
    got = port(codes, seg_ids, valid, thresh)
    want = _ref_step(kind, host, mp, table, weighted, n_data, n_table,
                     n_seqs)(
        codes, seg_ids, valid, jnp.float32(thresh) if weighted
        else jnp.int32(thresh))
    if weighted:
        _check_weighted(got, want, _single_device_weighted(
            table, codes, seg_ids, valid, n_seqs, thresh))
    else:
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and np.array_equal(g.numpy(), w)
        assert (want[0] >= 0).any()


@pytest.mark.parametrize("n_table,capacity", [(2, None), (3, None),
                                              (4, None), (2, 64), (3, 8),
                                              (4, 8)])
@pytest.mark.parametrize("weights", ["none", "balance"])
def test_routed_step_matches_reference(tables, streams, n_table, capacity,
                                       weights):
    """Roles, hits and the overflow flag; a capacity of 64 or 8 a bucket
    overflows in both packages."""
    n_data = 8 // n_table
    codes, seg_ids, valid, n_seqs = _first_rows(streams, n_data)
    inputs = _routed_inputs(codes, seg_ids, valid, n_table, n_seqs)
    table = tables[weights][0]
    weighted = weights != "none"
    thresh = 0.5 if weighted else 1
    port, host, mp = _port_step("routed", table, weighted, n_data, n_table,
                                n_seqs, capacity=capacity)
    got = port(*inputs, thresh)
    want = _ref_step("routed", host, mp, table, weighted, n_data, n_table,
                     n_seqs, capacity=capacity)(
        *inputs, jnp.float32(thresh) if weighted else jnp.int32(thresh))
    assert got[2] == int(want[2]) == (capacity is not None)
    if capacity is not None:
        return      # an overflowed step undercounts, in both alike
    if weighted:
        _check_weighted(got, want, _single_device_weighted(
            table, codes, seg_ids, valid, n_seqs, thresh))
    else:
        for g, w in zip(got[:2], want[:2]):
            assert np.array_equal(g.numpy(), w)
        assert (want[0] >= 0).any()


@pytest.mark.parametrize("weights", ["none", "balance"])
def test_routed_step_with_owners_that_receive_no_key(tables, streams,
                                                     weights, monkeypatch):
    """Keys owned by shard 1 made invalid in every row, and one row with
    no valid window: owner 1 of every row, and every owner of that row,
    receive no key and look nothing up; the results still equal the
    reference's step."""
    from kmers_anno_tpu_torch.ops.hashing import mix_kmer
    from kmers_anno_tpu_torch.ops.kmers import pack_kmer_windows

    n_data, n_table = 2, 3
    codes, seg_ids, valid, n_seqs = _first_rows(streams, n_data)
    inputs = _routed_inputs(codes, seg_ids, valid, n_table, n_seqs)
    sc, sv = inputs[0], inputs[2].copy()
    for r in range(n_data):
        for c in range(n_table):
            lo, hi = pack_kmer_windows(torch.from_numpy(sc[r, c]), K)
            sv[r, c] &= (mix_kmer(lo, hi) % n_table != 1).numpy()
    sv[1] = False
    inputs[2] = sv
    table = tables[weights][0]
    weighted = weights != "none"
    thresh = 0.5 if weighted else 1
    sizes = []

    def spy(table, lo, *a, **kw):
        sizes.append(lo.numel())
        return probe_keys(table, lo, *a, **kw)

    monkeypatch.setattr(port_mesh, "probe_keys", spy)
    port, host, mp = _port_step("routed", table, weighted, n_data, n_table,
                                n_seqs)
    got = port(*inputs, thresh)
    want = _ref_step("routed", host, mp, table, weighted, n_data, n_table,
                     n_seqs)(
        *inputs, jnp.float32(thresh) if weighted else jnp.int32(thresh))
    assert sizes[1] == 0 and sizes[3:] == [0, 0, 0]
    assert sizes[0] > 0 and sizes[2] > 0
    assert got[2] == int(want[2]) == 0
    for g, w in zip(got[:2], want[:2]):
        assert np.array_equal(g.numpy(), w)
    assert (want[0][0] >= 0).any() and (want[0][1] == -1).all()


def test_routed_overflow_undercounts_like_the_reference(tables, streams):
    codes, seg_ids, valid, n_seqs = streams
    inputs = _routed_inputs(codes, seg_ids, valid, 2, n_seqs)
    table = tables["none"][0]
    port, host, mp = _port_step("routed", table, False, 4, 2, n_seqs,
                                capacity=256)
    got = port(*inputs, 1)
    want = _ref_step("routed", host, mp, table, False, 4, 2, n_seqs,
                     capacity=256)(*inputs, jnp.int32(1))
    assert got[2] == int(want[2]) == 1
    for g, w in zip(got[:2], want[:2]):
        assert np.array_equal(g.numpy(), w)


@pytest.fixture(scope="module")
def dna_genomes():
    gs = []
    for i in range(5):
        specs = [(name, 300 + 30 * j, "+" if (i + j) % 2 else "-")
                 for j, (rid, name) in enumerate(ROLE_DEFS[:4])]
        gs.append(make_dna_genome(f"88{i}.1", seed=700 + i, cds_specs=specs))
    return gs


@pytest.fixture(scope="module")
def dna_tables(dna_genomes):
    return {mode: port_sig.build_signatures(
        dna_genomes, make_role_map(), GOOD, k=K, progress=False,
        alphabet="dna", device="cpu",
        weight_mode=mode)
        for mode in ("none", "balance")}


@pytest.mark.parametrize("n_data,n_table", [(2, 1), (4, 2), (1, 8)])
@pytest.mark.parametrize("weights", ["none", "balance"])
def test_dna_probe_steps_match_reference(dna_genomes, dna_tables, n_data,
                                         n_table, weights):
    table = dna_tables[weights]
    batches = [DnaContigBatch([(c.id, c.sequence) for c in g.contigs], K)
               for g in (dna_genomes * 2)[:n_data]]
    width = max(len(b.codes) for b in batches)
    codes = np.full((n_data, width), 5, np.uint8)
    valid = np.zeros((n_data, width), bool)
    for i, b in enumerate(batches):
        codes[i, : len(b.codes)] = b.codes
        valid[i, : len(b.valid)] = b.valid
    host, mp = _tables(table, weights != "none", n_table)
    mesh = port_mesh.make_mesh(n_data, n_table, members(n_data * n_table))
    placed = port_mesh.MemberTables(mesh, host, range(n_data),
                                    n_table > 1)
    build = (port_mesh.replicated_probe_step if n_table == 1
             else port_mesh.sharded_probe_step)
    got = build(mesh, k=K, max_probes=mp)(placed, codes, valid)
    ref_build = (ref_mesh.replicated_probe_step if n_table == 1
                 else ref_mesh.sharded_probe_step)
    want = np.asarray(ref_build(ref_mesh.make_mesh(n_data, n_table), k=K,
                                max_probes=mp)(
        jnp.asarray(host[0] if n_table == 1 else host), codes, valid))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 100


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def expected(genomes, tables):
    engine = KmerApplyEngine(tables["none"][0], min_hits=1, device="cpu")
    return [[(f.id, role, hits) for f, role, hits in engine.call_genome(g)]
            for g in genomes]


@pytest.mark.parametrize("n_data,n_table,mode", SHAPES)
def test_mesh_engine_matches_single_device_and_reference(
        genomes, tables, expected, n_data, n_table, mode):
    port, ref = tables["none"]
    got = _calls(port_engine.MeshApplyEngine(
        port, n_data, n_table, min_hits=1, mode=mode,
        devices=members(n_data * n_table)), genomes)
    assert got == expected
    assert got == _calls(ref_engine.MeshApplyEngine(
        ref, n_data, n_table, min_hits=1, mode=mode), genomes)
    assert sum(map(len, got)) > 20


@pytest.mark.parametrize("weighted,n_table", [(False, 4), (True, 4),
                                              (False, 3), (True, 3)],
                         ids=["False", "True", "False-3", "True-3"])
def test_routed_capacity_retry_is_exact(genomes, tables, expected, weighted,
                                        n_table, caplog):
    port, _ = tables["balance" if weighted else "none"]
    kw = dict(weighted=True, min_weight=0.5) if weighted else {}
    want = _calls(_SingleGenomes(port, kw), genomes) if weighted else expected
    with caplog.at_level(logging.INFO, logger=port_engine.__name__):
        got = _calls(port_engine.MeshApplyEngine(
            port, 2, n_table, min_hits=1, mode="routed",
            capacity_factor=0.01, devices=members(2 * n_table), **kw),
            genomes)
    assert got == want
    assert sum("overflowed" in r.getMessage() for r in caplog.records) == 3


class _SingleGenomes:
    """The port's single-device engine with the mesh engines'
    ``call_genomes``."""

    def __init__(self, table, kw):
        self.engine = KmerApplyEngine(table, min_hits=1, device="cpu", **kw)

    def call_genomes(self, genomes):
        for g in genomes:
            yield g, self.engine.call_genome(g)


@pytest.mark.parametrize("n_data,n_table,mode", [
    (8, 1, "auto"), (4, 2, "pmax"), (4, 2, "routed"), (1, 8, "routed")])
def test_weighted_mesh_engine_matches_single_device(
        genomes, tables, n_data, n_table, mode):
    """Calls equal the port's single-device engine exactly (tallies to
    their four printed places included), and the reference's mesh engine
    with roles exact and tallies within rtol 1e-5."""
    port, ref = tables["balance"]
    kw = dict(weighted=True, min_weight=0.5)
    want = _calls(_SingleGenomes(port, kw), genomes)
    got = _calls(port_engine.MeshApplyEngine(
        port, n_data, n_table, min_hits=1, mode=mode,
        devices=members(n_data * n_table), **kw), genomes)
    assert got == want
    ref_calls = _calls(ref_engine.MeshApplyEngine(
        ref, n_data, n_table, min_hits=1, mode=mode, **kw), genomes)
    assert [[c[:2] for c in g] for g in got] == [[c[:2] for c in g]
                                                 for g in ref_calls]
    np.testing.assert_allclose([c[2] for g in got for c in g],
                               [c[2] for g in ref_calls for c in g],
                               rtol=1e-5)
    assert any(c[2] != round(c[2]) for g in got for c in g)


def _dna_calls(engine, genomes):
    if isinstance(engine, DnaApplyEngine):
        pairs = ((g, engine.call_genome(g)) for g in genomes)
    else:
        pairs = engine.call_genomes(genomes)
    return [[(f.id, f.location.strand, f.location.left, f.location.right,
              role, hits) for f, role, hits in calls]
            for _, calls in pairs]


@pytest.mark.parametrize("n_data,n_table", [(8, 1), (4, 2), (1, 8)])
@pytest.mark.parametrize("weights", ["none", "balance"])
def test_dna_mesh_engine_matches_single_device(dna_genomes, dna_tables,
                                               n_data, n_table, weights):
    table = dna_tables[weights]
    kw = ({} if weights == "none"
          else dict(weighted=True, min_weight=1.0))
    single = _dna_calls(DnaApplyEngine(table, min_hits=3, device="cpu",
                                       **kw), dna_genomes)
    meshed = _dna_calls(port_engine.DnaMeshApplyEngine(
        table, n_data, n_table, min_hits=3,
        devices=members(n_data * n_table), **kw), dna_genomes)
    assert meshed == single
    assert any(single)


def test_engines_refuse_what_they_cannot_run(tables, dna_tables):
    port = tables["none"][0]
    with pytest.raises(ValueError, match="sharded modes need a table axis"):
        port_engine.MeshApplyEngine(port, 2, 1, mode="routed",
                                    devices=members(2))
    with pytest.raises(ValueError, match="unknown table mode"):
        port_engine.MeshApplyEngine(port, 2, 2, mode="sliced",
                                    devices=members(4))
    with pytest.raises(ValueError, match="need 4 devices, have 3"):
        port_engine.MeshApplyEngine(port, 2, 2, devices=members(3))
    with pytest.raises(ValueError, match="DnaMeshApplyEngine"):
        port_engine.MeshApplyEngine(dna_tables["none"], 2, 1,
                                    devices=members(2))
    with pytest.raises(ValueError, match="requires a DNA table"):
        port_engine.DnaMeshApplyEngine(port, 2, 1, devices=members(2))


def test_no_kernel_launches_on_cpu_members(genomes, tables):
    """CPU members take the plain versions: the key-lookup kernel's count
    does not move."""
    before = probe_keys.launches
    engine = port_engine.MeshApplyEngine(tables["none"][0], 2, 2,
                                         min_hits=1, devices=members(4))
    _calls(engine, genomes[:2])
    assert probe_keys.launches == before
