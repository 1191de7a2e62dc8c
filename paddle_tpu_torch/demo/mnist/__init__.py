"""The port's copy of ``demo/mnist``."""
