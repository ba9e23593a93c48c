"""Frozen reference: see portbench/README.md."""
