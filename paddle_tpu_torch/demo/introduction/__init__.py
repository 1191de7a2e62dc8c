"""The port's copy of ``demo/introduction``."""
