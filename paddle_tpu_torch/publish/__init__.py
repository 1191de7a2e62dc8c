"""Continuous model publication — the port's ``paddle_tpu/publish``.

The gated publisher closes the train->serve loop: every ``--publish_every``
passes the trainer exports a quantize-gated deploy bundle into a versioned,
CRC-manifested publish directory — but ONLY from a checkpoint pass the
scrubber has verified (``latest_verified_pass``;
``resilience/integrity.py``).  A live server watches the directory and
hot-swaps new versions with zero dropped requests (``serving/reload.py``).
A version directory written by either package loads in the other.
"""

from paddle_tpu_torch.publish.publisher import (PublishRefused, Publisher,
                                                freshness_from_journal,
                                                latest_version,
                                                list_model_dirs,
                                                list_versions,
                                                model_publish_dir,
                                                publish_cache_dir,
                                                publish_from_checkpoints,
                                                read_version_manifest,
                                                validate_version,
                                                version_dir)

__all__ = [
    "PublishRefused", "Publisher", "freshness_from_journal",
    "latest_version", "list_model_dirs", "list_versions",
    "model_publish_dir", "publish_cache_dir",
    "publish_from_checkpoints", "read_version_manifest",
    "validate_version", "version_dir",
]
