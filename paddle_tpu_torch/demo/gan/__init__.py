"""The port's copy of ``demo/gan``."""
