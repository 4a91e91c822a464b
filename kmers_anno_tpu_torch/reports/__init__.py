"""Report writers (copies of the reference package's ``reports/``)."""
