"""Ingest-side services: MinHash signing and banded-LSH candidates."""
