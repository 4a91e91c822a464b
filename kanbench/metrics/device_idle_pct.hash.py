"""The share of the window in which no kernel or copy ran on the device,
in the hashAnno cells."""

SPANS = (("kmers_anno_tpu_torch.engine.hashanno", "annotate_genomes_batched",
          "batch", True),)
COUNTS = ()


def read(trace):
    return trace.idle_pct()
