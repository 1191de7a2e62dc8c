"""The port's copy of ``demo/word2vec``."""
