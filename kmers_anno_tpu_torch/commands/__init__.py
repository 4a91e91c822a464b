"""CLI command processors of the port (so far ``kmers`` and ``batch``)."""
