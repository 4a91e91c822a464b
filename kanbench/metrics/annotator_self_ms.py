"""Milliseconds a genome in ``annotate_genome`` outside the close set and
the fused scan: the stream index, the union probe, the ORF state, the
replay and the features."""

SPANS = (("cell.annot", "annotate_genome", "annotate", True),
         ("cell.annot", "_close_set", "close_set", True),
         ("kmers_anno_tpu_torch.engine.projection", "_scan_genomes", "scan",
          True))
COUNTS = ()


def read(trace):
    return trace.self_ms_per_genome("annotate", ("close_set", "scan"))
