"""Dataset preprocessing toolkit: ``preprocess`` and ``download``."""
