"""The port's copy of ``demo/traffic_prediction``."""
