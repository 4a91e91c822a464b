"""The share of the window in which no kernel or copy ran on the device,
in the projection cells."""

SPANS = (("cell.annot", "annotate_genome", "annotate", True),
         ("cell.annot", "_close_set", "close_set", True),
         ("kmers_anno_tpu_torch.engine.projection", "_scan_genomes", "scan",
          True))
COUNTS = ()


def read(trace):
    return trace.idle_pct()
