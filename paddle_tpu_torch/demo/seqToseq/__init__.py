"""The port's copy of ``demo/seqToseq``."""
