"""Host utilities: counting maps, tabular readers, prefetching (copies of
the reference package's ``utils/`` modules)."""
