"""The port's copy of ``demo/quick_start``."""
