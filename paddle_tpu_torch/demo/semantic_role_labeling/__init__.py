"""The port's copy of ``demo/semantic_role_labeling``."""
