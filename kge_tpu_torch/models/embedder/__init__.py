"""Embedder configuration files (lookup_embedder.yaml,
projection_embedder.yaml, tucker3_relation_embedder.yaml)."""
