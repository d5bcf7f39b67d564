"""Embedder configuration files (lookup_embedder.yaml)."""
