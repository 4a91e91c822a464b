"""Two-process mesh ``apply`` on gloo (the port's counterpart of
``tests/test_multiprocess.py``).

Two real OS processes joined by ``KAN_COORDINATOR`` / ``KAN_NUM_PROCESSES``
/ ``KAN_PROCESS_ID``, each contributing 2 virtual CPU members, run
``apply --mesh 4x1 --device cpu``.  The primary's report must equal one
process's byte for byte, and the secondary's must be the header alone.
Each process has its own timeout (``run_ranks``), so a rendezvous that
hangs fails the test instead of eating the suite's clock.
"""

import sys

import pytest

from kmers_anno_tpu.commands.app import main as ref_main
from kmers_anno_tpu_torch.commands.app import main as port_main
from tests.fixtures import make_genome, write_role_files
from tests.test_torch_distributed import run_ranks


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp")
    role_file, use_file = write_role_files(tmp)
    gdir = tmp / "gtos"
    gdir.mkdir()
    for i in range(8):
        make_genome(f"77{i}.1", seed=100 + i).save(str(gdir / f"77{i}.1.gto"))
    db = str(tmp / "kmer.db")
    assert ref_main(["build", "-K", "8", "-o", db, role_file, use_file,
                     str(gdir)]) == 0
    want = str(tmp / "single.tbl")
    assert port_main(["apply", "--device", "cpu", "-m", "3", "--format",
                      "VERIFY", "-o", want, db, use_file, str(gdir)]) == 0
    return dict(db=db, use_file=use_file, gdir=str(gdir),
                want=open(want).read())


@pytest.mark.parametrize("mesh", ["4x1", "2x2"])
def test_two_process_mesh_apply(workload, tmp_path, mesh):
    outs = [str(tmp_path / f"out{rank}.tbl") for rank in (0, 1)]
    runs = run_ranks([sys.executable, "-c",
                      "import sys\n"
                      "from kmers_anno_tpu_torch.commands.app import main\n"
                      "sys.exit(main(sys.argv[1:]))",
                      "apply", "--mesh", mesh, "--device", "cpu", "-m", "3",
                      "--format", "VERIFY", "-o", "{out}", workload["db"],
                      workload["use_file"], workload["gdir"]], outs=outs)
    for rc, _, err in runs:
        assert rc == 0, err[-3000:]
    got = open(outs[0]).read()
    assert got == workload["want"]
    assert len(got.splitlines()) > 20
    # the secondary wrote the header alone, no genome rows
    other = open(outs[1]).read().splitlines()
    assert other == got.splitlines()[:1]
