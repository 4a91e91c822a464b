"""hashAnno's layer for ``inside.py``'s readers of the program's spans
(``kmers_anno_tpu_torch.engine.hashanno``): importing this module names
``hash.batch`` (a batch's whole call) as the span that says the ``hash.*``
spans' layer ran, so ``inside.ms_per_genome`` reads them with its rules.
Like ``inside``, it turns the program's tracer on when imported."""

from __future__ import annotations

from . import inside

inside.LAYERS.setdefault("hash", "hash.batch")
ms_per_genome = inside.ms_per_genome
