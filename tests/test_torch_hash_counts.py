"""The benchmark's counts of hashAnno's chunk kernels
(``kanbench/counts/kan_hash_commons.py``, ``kan_hash_best.py``): on a
hand-sized chunk, bytes and integer operations equal to a count written
out by hand; on the smoke's bench chunk (``chip_smoke.make_hash_bench``,
chunk 0), equal to what ``chip_smoke.hash_commons_bound`` and
``hash_best_bound`` report.  On the CPU; the file imports no jax.
"""

from __future__ import annotations


import numpy as np
import pytest
import torch

from kanbench.tablewalk import GOLDEN, mix
from kanbench.trace import load_module
from kmers_anno_tpu_torch.engine import hashanno
from kmers_anno_tpu_torch.ops.hash_chunk import hash_commons_plain
from kmers_anno_tpu_torch.ops.hashtable import build_table

COMMONS = load_module("counts", "kan_hash_commons")
BEST = load_module("counts", "kan_hash_best")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module's tests run: the suite runs
    several workers, and their threads would outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys_home(n_buckets: int, home: int, n: int, start: int) -> list:
    """``n`` (lo, hi) keys whose home bucket in an ``n_buckets`` table is
    ``home``."""
    out, lo = [], start
    while len(out) < n:
        b = int(mix(torch.tensor([lo]), torch.tensor([7]), GOLDEN)[0]
                & (n_buckets - 1))
        if b == home:
            out.append((lo, 7))
        lo += 1
    return out


@pytest.fixture(scope="module")
def hand():
    """A 2-bucket table: bucket 0 full with 8 keys homed there, a 9th key
    homed there too, walked into bucket 1; rows 0, 3 and 8 of a (9, 2)
    owner matrix filled, the hits naming 0 and 8.  A chunk of 6 kmers, 5
    valid, over 2 prototype rows."""
    at0 = _keys_home(2, 0, 10, 1000)
    at1 = _keys_home(2, 1, 1, 5000)
    keys = at0[:9]
    table, max_probes = build_table(
        np.array([k[0] for k in keys], np.uint32),
        np.array([k[1] for k in keys], np.uint32),
        np.arange(9, dtype=np.uint32), n_buckets=2)
    assert max_probes == 2
    n_pad = 4
    owner_mat = np.full((9, 2), n_pad, np.int32)
    owner_mat[0] = [0, 1]           # rank 0: owners 0 and 1
    owner_mat[8] = [2, n_pad]       # rank 8 (the walked key): owner 2
    owner_mat[3] = [1, 3]
    chunk = [  # (key, prototype row, valid)
        (at0[0], 0, True),          # hit, bucket 0, owners 0, 1
        (at0[8], 0, True),          # hit after a walk, owner 2
        (at0[0], 1, True),          # hit, row 1, owners 0, 1
        (at0[9], 1, True),          # miss homed at 0: walks to bucket 1
        (at1[0], 1, True),          # miss homed at 1: one read
        (at0[3], 0, False),         # invalid: no read
    ]
    def t(v):
        return torch.tensor(np.array(v, np.int64).astype(np.int32))

    return dict(
        table=torch.from_numpy(table.view(np.int32)), max_probes=2,
        owner_mat=torch.from_numpy(owner_mat),
        lo=t([c[0][0] for c in chunk]), hi=t([c[0][1] for c in chunk]),
        proto=t([c[1] for c in chunk]),
        valid=torch.tensor([c[2] for c in chunk]), n_rows=2, n_pad=n_pad)


def _commons_args(c):
    return (c["table"], c["max_probes"], c["owner_mat"], c["lo"], c["hi"],
            c["proto"], c["valid"], c["n_rows"], c["n_pad"])


def test_the_walk_by_hand(hand):
    buckets, reads, ranks = COMMONS.walk(hand["table"], hand["lo"], hand["hi"],
                                       hand["valid"], hand["max_probes"])
    assert buckets == 2
    assert reads == 1 + 2 + 1 + 2 + 1
    assert ranks.tolist() == [0, 8, 0, -1, -1, -1]


def test_commons_count_by_hand(hand):
    # 6 chunk kmers; 2 distinct buckets read; 3 hits; owner rows 0 and 8
    # of cap 2; cells (0, 0), (0, 1), (0, 2), (1, 0), (1, 1)
    want_bytes = 13 * 6 + 32 * 2 + 8 * 3 + 4 * 2 * 2 + 4 * 5
    # 5 valid kmers hashed; 7 bucket reads; 3 hits over 2 owner slots
    want_ops = 14 * 5 + 16 * 7 + 2 * 2 * 3
    assert COMMONS.count(*_commons_args(hand)) == (want_bytes, want_ops)
    common = hash_commons_plain(*_commons_args(hand))
    assert int((common != 0).sum()) == 5


def test_best_count_by_hand(hand):
    n_rows, n_pad = hand["n_rows"], hand["n_pad"]
    minc = torch.zeros(1024, dtype=torch.int32)
    common = torch.zeros((n_rows + 1, n_pad), dtype=torch.int32)
    n1 = torch.zeros(n_pad, dtype=torch.int32)
    n2 = torch.zeros(n_rows + 1, dtype=torch.int32)
    # 8 cells read, n1 and n2 of the chunk's rows, the 4 KiB floor table,
    # the state (12 B a protein) read and written
    want_bytes = 4 * 8 + 4 * 4 + 4 * 2 + 4096 + 2 * 12 * 4
    want_ops = 2 * 8
    assert BEST.count(common, n_rows, n1, n2, minc, None, 0) == \
        (want_bytes, want_ops)
    assert BEST.KERNELS == ("hash_best_kernel",)
    assert BEST.WRAPPERS == (("kmers_anno_tpu_torch.engine.hashanno",
                              "hash_best"),)


@pytest.fixture(scope="module")
def bench_chunk():
    """The smoke's bench chunk 0: its index, first chunk and device run,
    on the CPU."""
    import chip_smoke

    genomes, protos = chip_smoke.make_hash_bench(
        np.random.default_rng(chip_smoke.HASH_SEED))
    gk = hashanno.GenomeProteinKmers(chip_smoke.K, chip_smoke.HASH_MIN_SCORE,
                                     device="cpu")
    for gi, prots in enumerate(genomes):
        for i, p in enumerate(prots):
            gk.add_protein(f"fig|{gi}.peg.{i}", p, "hypothetical protein")
    gk._build()
    chunk = min(chip_smoke.HASH_CHUNK, (1 << 26) // (gk.n_pad + 1) - 1)
    pset = hashanno.PrototypeSet(protos[:chunk], chip_smoke.K)
    chunks = pset.chunks(chunk, torch.device("cpu"))
    max_len = max(max(map(len, gk._proteins)),
                  max(len(p.protein) for p in protos))
    run = gk._device_run(chunks, max_len)
    d_lo, d_hi, d_proto, d_valid, _, sub, _, d_n2 = chunks[0]
    c = dict(table=gk.table, max_probes=gk.max_probes,
             owner_mat=gk.owner_mat, lo=d_lo, hi=d_hi, proto=d_proto,
             valid=d_valid, n_rows=len(sub), n_pad=gk.n_pad, n1=run[1],
             n2=d_n2, minc=run[0])
    return gk, chunks[0], run, c


def test_counts_equal_the_smokes_bounds_on_its_bench_chunk(bench_chunk):
    import chip_smoke
    from kmers_anno_tpu_torch.ops.hashtable import probe_table

    _, _, run, c = bench_chunk
    args = chip_smoke.hash_chunk_args(c)
    want = hash_commons_plain(*args)
    n_touched = int((want != 0).sum())
    ranks = probe_table(c["table"], c["lo"], c["hi"], c["valid"],
                        c["max_probes"])
    smoke = chip_smoke.hash_commons_bound(c, ranks, n_touched, 1.0)
    got = COMMONS.count(*args, out=run[3])
    assert got == (smoke["bound_bytes"], smoke["bound_ops"])
    assert smoke["hits"] > 0 and n_touched > 0
    # the best count leaves out the clears of the non-zero cells: the
    # smoke's bound of a chunk with none, a small share of the whole
    minc, n1, state, common = run
    got_best = BEST.count(common, c["n_rows"], n1, c["n2"], minc, state, 0)
    smoke_best = chip_smoke.hash_best_bound(c, 0, 1.0)
    assert got_best == (smoke_best["bound_bytes"], smoke_best["bound_ops"])
    whole = chip_smoke.hash_best_bound(c, n_touched, 1.0)
    assert whole["bound_bytes"] - got_best[0] == 4 * n_touched
    assert 4 * n_touched < 0.01 * got_best[0]
    # the walk's payloads are the probe's ranks
    _, _, w_ranks = COMMONS.walk(c["table"], c["lo"], c["hi"], c["valid"],
                               c["max_probes"])
    assert torch.equal(w_ranks.to(torch.int32), ranks)
