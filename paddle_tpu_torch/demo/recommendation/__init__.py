"""The port's copy of ``demo/recommendation``."""
