"""CLI command processors of the port: all 16 commands of the reference."""
