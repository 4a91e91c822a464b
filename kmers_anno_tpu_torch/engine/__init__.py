"""Annotation engines of the port (so far: ORF projection)."""
