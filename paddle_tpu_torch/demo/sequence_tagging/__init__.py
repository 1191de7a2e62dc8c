"""The port's copy of ``demo/sequence_tagging``."""
