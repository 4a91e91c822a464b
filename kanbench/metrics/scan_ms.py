"""Milliseconds a genome in the fused scan of the close genomes' tables."""

SPANS = (("kmers_anno_tpu_torch.engine.projection", "_scan_genomes", "scan",
          True),)
COUNTS = ()


def read(trace):
    return trace.span_ms_per_genome("scan")
