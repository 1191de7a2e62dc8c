"""The port's copy of ``demo/sentiment``."""
