"""The port's copy of ``demo/image_classification``."""
