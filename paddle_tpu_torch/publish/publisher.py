"""Gated model publication: verified checkpoint -> versioned deploy bundle
— the port's ``paddle_tpu/publish/publisher.py``.

Layout of a publish directory (the reference's, so either package reads
the other's versions)::

    publish_dir/
      v-00001/
        model.ptz       # the deploy bundle (config/deploy.py merge_model)
        manifest.json   # version, pass_id, train_commit_time, CRC32s,
                        # architecture fingerprint, quantize recipe
      v-00002/ ...
      ccache/           # shared compile cache (config/compile_cache.py):
                        # the built kernel libraries every published
                        # version's forward runs

The gate: a version is only ever cut from a checkpoint pass at or below
``latest_verified_pass(save_dir)`` (resilience/integrity.py) whose
directory still CRC-validates — an unverified or quarantined pass is
unpublishable by construction, and the bundle bytes come from the verified
checkpoint on disk, never from live trainer memory.  Every publish writes
through the checkpoint_io discipline: dot-prefixed temp dir, per-file
fsync, one ``os.replace``.  Attempts and refusals are journaled
(``publish_commit`` / ``publish_refused``).
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import time
import uuid
import zlib
from typing import Any, Dict, List, Optional

from paddle_tpu_torch.utils.log import logger

__all__ = ["PublishRefused", "Publisher", "freshness_from_journal",
           "latest_version", "list_model_dirs", "list_versions",
           "model_publish_dir", "publish_cache_dir",
           "publish_from_checkpoints", "read_version_manifest",
           "validate_version", "version_dir"]

_VERSION_RE = re.compile(r"v-(\d{5,})$")
_TMP_PREFIX = ".tmp-"
#: the bundle member every version dir carries
BUNDLE_NAME = "model.ptz"
MANIFEST_NAME = "manifest.json"
#: shared compile cache for every version of the publish dir
CACHE_SUBDIR = "ccache"


class PublishRefused(RuntimeError):
    """The gate refused to cut a version: the requested pass is newer
    than ``latest_verified_pass``, its checkpoint no longer validates,
    or the quantize error gate failed.  ``reason`` is the machine-
    readable signal the refusal was journaled under."""

    def __init__(self, message: str, *, reason: str,
                 pass_id: Optional[int] = None) -> None:
        super().__init__(message)
        self.reason = reason
        self.pass_id = pass_id


def version_dir(publish_dir: str, version: int) -> str:
    return os.path.join(publish_dir, f"v-{version:05d}")


def list_versions(publish_dir: str) -> List[int]:
    """Every published version number, ascending (temp dirs and the
    shared cache are never matched)."""
    try:
        names = os.listdir(publish_dir)
    except FileNotFoundError:
        return []
    out = []
    for n in names:
        m = _VERSION_RE.fullmatch(n)
        if m and os.path.isdir(os.path.join(publish_dir, n)):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_version(publish_dir: str) -> int:
    """Newest published version number, or 0 when none exist."""
    vs = list_versions(publish_dir)
    return vs[-1] if vs else 0


#: model names must be safe as directory components AND unambiguous
#: against version dirs / the shared cache
_MODEL_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9._-]*$")


def model_publish_dir(publish_root: str, name: str) -> str:
    """One model's watch dir under a fleet publish root
    (``<root>/<name>/v-NNNNN/...``): each fleet model gets its own
    version sequence, manifest chain, and shared compile cache, so
    publishing model A can never perturb model B's rollout."""
    if not _MODEL_RE.fullmatch(name or "") or _VERSION_RE.fullmatch(name) \
            or name == CACHE_SUBDIR or name.startswith(_TMP_PREFIX):
        raise ValueError(f"invalid publish model name {name!r}")
    return os.path.join(publish_root, name)


def list_model_dirs(publish_root: str) -> List[str]:
    """Model names under a fleet publish root, sorted — a directory
    counts as a model iff it holds at least one version dir (stray
    dirs and the flat single-model layout are never misread)."""
    try:
        names = os.listdir(publish_root)
    except FileNotFoundError:
        return []
    out = []
    for n in sorted(names):
        if not _MODEL_RE.fullmatch(n) or _VERSION_RE.fullmatch(n) \
                or n == CACHE_SUBDIR or n.startswith(_TMP_PREFIX):
            continue
        if list_versions(os.path.join(publish_root, n)):
            out.append(n)
    return out


def read_version_manifest(vdir: str) -> Dict[str, Any]:
    with open(os.path.join(vdir, MANIFEST_NAME)) as f:
        return json.load(f)


def validate_version(vdir: str) -> Optional[str]:
    """Re-hash one published version against its manifest; returns the
    failure reason (naming the damaged member) or None.  The at-rest
    integrity check the reload path runs before trusting a version —
    the publish-tier analog of ``validate_checkpoint``."""
    try:
        manifest = read_version_manifest(vdir)
    except FileNotFoundError:
        return f"missing {MANIFEST_NAME}"
    except (json.JSONDecodeError, OSError) as e:
        return f"{MANIFEST_NAME} unreadable: {e}"
    for fname, want in (manifest.get("files") or {}).items():
        path = os.path.join(vdir, fname)
        try:
            with open(path, "rb") as f:
                crc = zlib.crc32(f.read())
        except OSError as e:
            return f"member {fname} unreadable: {e}"
        if crc != int(want.get("crc32", -1)):
            return (f"member {fname} CRC mismatch "
                    f"(stored {want.get('crc32')}, computed {crc})")
    if not (manifest.get("files") or {}):
        return "manifest lists no files"
    return None


def publish_cache_dir(publish_dir: str):
    """The publish directory's shared compile cache — the kernel libraries
    every published weight version's forward runs."""
    from paddle_tpu_torch.config.compile_cache import CompileCacheDir

    return CompileCacheDir(os.path.join(publish_dir, CACHE_SUBDIR))


def _journal_refused(reason: str, message: str,
                     pass_id: Optional[int]) -> PublishRefused:
    from paddle_tpu_torch.obs.journal import journal_event

    journal_event("publish_refused", reason=reason, detail=message,
                  pass_id=pass_id)
    logger.warning("publish refused (%s): %s", reason, message)
    return PublishRefused(message, reason=reason, pass_id=pass_id)


def _load_checkpoint_trees(topology, ckpt_dir: str):
    """Restore params/state on the CPU from the VERIFIED checkpoint's bytes
    — the published weights are the scrubbed artifact, not live memory.
    Only the arrays ``topology`` needs are read (an inference graph may
    publish from a training run's checkpoint)."""
    import torch

    from paddle_tpu_torch.resilience.checkpoint_io import (load_pytree,
                                                           read_manifest)

    manifest = read_manifest(ckpt_dir)
    specs = topology.param_specs
    like_p = {n: torch.empty(0) for n, s in specs.items() if not s.is_state}
    like_s = {n: torch.empty(0) for n, s in specs.items() if s.is_state}

    def dtypes_of(fname: str) -> Dict[str, str]:
        arrays = ((manifest.get("files") or {}).get(fname) or {}).get(
            "arrays") or {}
        return {k: v.get("orig_dtype") for k, v in arrays.items()
                if v.get("orig_dtype")}

    params = load_pytree(os.path.join(ckpt_dir, "params.npz"), like_p,
                         dtypes_of("params.npz"))
    state = {}
    if like_s and manifest.get("has_state"):
        state = load_pytree(os.path.join(ckpt_dir, "state.npz"), like_s,
                            dtypes_of("state.npz"))
    return params, state, manifest


def publish_from_checkpoints(
    publish_dir: str,
    topology,
    save_dir: str,
    *,
    pass_id: Optional[int] = None,
    name: str = "model",
    quantize: Optional[str] = None,
    quantize_tol: float = 0.05,
    example_feed: Optional[Dict[str, Any]] = None,
    warm_cache: bool = True,
    warm_max_batch: int = 8,
    meta: Optional[dict] = None,
    device=None,
    timings: Optional[Dict[str, float]] = None,
) -> str:
    """Cut one gated, versioned publish from the checkpoint tier.

    ``pass_id`` defaults to ``latest_verified_pass(save_dir)``; an
    explicit pass NEWER than the verified tip — or one whose checkpoint
    dir is quarantined or no longer CRC-validates — raises the typed
    :class:`PublishRefused` (journaled as ``publish_refused``), so an
    unverified pass is unpublishable by construction.

    The bundle export runs the full ``merge_model`` plane (the quantize
    error gate; ``example_feed``, the deploy lint's input, is refused with
    it, ROADMAP.md Queue 1 item 9); with ``warm_cache`` the new model's
    batch buckets are primed on ``device`` (the card unless the caller
    asks otherwise) against the publish dir's SHARED compile cache, so a
    reload — or a fresh boot of any version — runs no compiler.
    ``timings`` (a dict), when given, receives the seconds of the merge,
    the gate's reload of the bundle and the warm step.  Returns the
    published version directory."""
    from paddle_tpu_torch.config.deploy import (load_inference_model,
                                                merge_model)
    from paddle_tpu_torch.obs.journal import journal_event
    from paddle_tpu_torch.resilience.checkpoint_io import (
        _fsync_dir, _fsync_file, pass_dir, quarantine_reason,
        validate_checkpoint)
    from paddle_tpu_torch.resilience.integrity import latest_verified_pass

    t_publish0 = time.time()
    verified = latest_verified_pass(save_dir)
    requested = verified if pass_id is None else int(pass_id)
    if requested < 0:
        raise _journal_refused(
            "no_verified_pass",
            f"no verified checkpoint under {save_dir!r} to publish",
            requested)
    if requested > verified:
        raise _journal_refused(
            "pass_not_verified",
            f"pass {requested} is newer than the latest verified pass "
            f"{verified} — the scrubber has not blessed it", requested)
    ckpt_dir = pass_dir(save_dir, requested)
    q = quarantine_reason(ckpt_dir)
    if q is not None:
        raise _journal_refused(
            "pass_quarantined",
            f"pass {requested} is quarantined: {q}", requested)
    bad = validate_checkpoint(ckpt_dir)
    if bad is not None:
        raise _journal_refused(
            "checkpoint_invalid",
            f"pass {requested} no longer validates: {bad}", requested)
    params, state, ckpt_manifest = _load_checkpoint_trees(topology, ckpt_dir)
    #: the freshness SLO's clock zero — the wall-clock the checkpoint
    #: tier committed this state at
    train_commit_time = float(ckpt_manifest.get("time") or t_publish0)

    os.makedirs(publish_dir, exist_ok=True)
    tmp = os.path.join(publish_dir, f"{_TMP_PREFIX}{uuid.uuid4().hex[:8]}")
    os.makedirs(tmp)
    try:
        bundle_meta = {
            **(meta or {}),
            "pass_id": requested,
            "train_commit_time": train_commit_time,
        }
        t0 = time.perf_counter()
        try:
            merge_model(os.path.join(tmp, BUNDLE_NAME), topology,
                        params, state or None, name=name, meta=bundle_meta,
                        example_feed=example_feed, quantize=quantize,
                        quantize_tol=quantize_tol)
        except ValueError as e:
            # the quantize error gate (or a structural export failure)
            # refuses typed like the verification gate — a bundle that
            # would serve degraded predictions is never published
            raise _journal_refused("export_gate", str(e), requested) from e
        t1 = time.perf_counter()
        # the architecture fingerprint is the identity every weight version
        # of the model shares
        model = load_inference_model(os.path.join(tmp, BUNDLE_NAME),
                                     arch_fingerprint=True, device=device)
        t2 = time.perf_counter()
        if warm_cache:
            _prime_bundle(model, publish_dir, warm_max_batch)
        t3 = time.perf_counter()
        if timings is not None:
            timings.update(merge_s=t1 - t0, load_s=t2 - t1, warm_s=t3 - t2)
        with open(os.path.join(tmp, BUNDLE_NAME), "rb") as f:
            crc = zlib.crc32(f.read())
        version = latest_version(publish_dir) + 1
        manifest = {
            "version": version,
            "name": name,
            "pass_id": requested,
            "train_commit_time": train_commit_time,
            "publish_time": time.time(),
            "fingerprint": model.fingerprint,
            "quantize": (model.manifest.get("quantize") or {}).get("mode"),
            "files": {BUNDLE_NAME: {"crc32": crc}},
        }
        mpath = os.path.join(tmp, MANIFEST_NAME)
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        _fsync_file(os.path.join(tmp, BUNDLE_NAME))
        _fsync_dir(tmp)
        final = version_dir(publish_dir, version)
        os.replace(tmp, final)
        _fsync_dir(publish_dir)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # fsync'd: the durable anchor the freshness SLO is reconstructed
    # against (freshness_from_journal)
    journal_event("publish_commit", fsync=True, version=version,
                  pass_id=requested, dir=final,
                  train_commit_time=train_commit_time,
                  fingerprint=model.fingerprint,
                  publish_s=round(time.time() - t_publish0, 3))
    logger.info("published v%d (pass %d) -> %s", version, requested, final)
    return final


def _prime_bundle(model, publish_dir: str, max_batch: int) -> None:
    """Prime every batch bucket of the new model against the publish dir's
    shared compile cache: the kernel libraries its forward runs are stored
    there (or found), so the server's reload — and any fresh boot of this
    or a later version — loads instead of building."""
    from paddle_tpu_torch.serving.batching import (batch_bucket,
                                                   warmup_bucket_feeds)
    from paddle_tpu_torch.serving.feeds import example_feed

    cache = publish_cache_dir(publish_dir)
    feed = example_feed(model.topology)
    buckets = sorted({batch_bucket(r, max_batch)
                      for r in range(1, max_batch + 1)})
    with contextlib.ExitStack() as stack:
        if model.device.type == "cuda":
            import torch

            stack.enter_context(torch.cuda.device(model.device))
        for padded in warmup_bucket_feeds(feed, buckets):
            model.prime(padded, cache=cache)


class Publisher:
    """Bound publisher: one publish directory + topology, republished
    every call (the trainer's ``--publish_every`` hook); ``device`` is
    where the warm step runs (the card unless the caller asks otherwise)."""

    def __init__(self, publish_dir: str, topology, *, name: str = "model",
                 quantize: Optional[str] = None, quantize_tol: float = 0.05,
                 warm_cache: bool = True, warm_max_batch: int = 8,
                 device=None) -> None:
        self.publish_dir = publish_dir
        self.topology = topology
        self.name = name
        self.quantize = quantize
        self.quantize_tol = quantize_tol
        self.warm_cache = warm_cache
        self.warm_max_batch = warm_max_batch
        self.device = device

    def publish(self, save_dir: str,
                pass_id: Optional[int] = None) -> str:
        return publish_from_checkpoints(
            self.publish_dir, self.topology, save_dir, pass_id=pass_id,
            name=self.name, quantize=self.quantize,
            quantize_tol=self.quantize_tol, warm_cache=self.warm_cache,
            warm_max_batch=self.warm_max_batch, device=self.device)


def freshness_from_journal(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Reconstruct the train-commit -> serving-ready freshness SLO from a
    merged journal timeline: one row per successful publish, carrying the
    publish latency (``train_commit_time`` -> ``publish_commit``), the
    swap time (``reload_commit``), and serving-ready (``probation_passed``
    — or the swap itself when no probation record exists yet).

    Input is ``merge_journals()`` output (or any list of journal records
    with ``kind``/``t`` fields)."""
    rows: Dict[int, Dict[str, Any]] = {}
    for r in events:
        kind, v = r.get("kind"), r.get("version")
        if v is None:
            continue
        v = int(v)
        if kind == "publish_commit":
            rows[v] = {
                "version": v,
                "pass_id": r.get("pass_id"),
                "train_commit_time": r.get("train_commit_time"),
                "published_at": r.get("t"),
                "swapped_at": None,
                "serving_ready_at": None,
                "rolled_back": False,
            }
        elif kind == "reload_commit" and v in rows:
            rows[v]["swapped_at"] = r.get("t")
            rows[v]["serving_ready_at"] = r.get("t")
        elif kind == "probation_passed" and v in rows:
            rows[v]["serving_ready_at"] = r.get("t")
        elif kind == "publish_rollback" and v in rows:
            rows[v]["rolled_back"] = True
            rows[v]["serving_ready_at"] = None
    out = []
    for v in sorted(rows):
        row = rows[v]
        t0, t1 = row.get("train_commit_time"), row.get("serving_ready_at")
        row["freshness_s"] = (round(float(t1) - float(t0), 3)
                              if t0 is not None and t1 is not None else None)
        out.append(row)
    return out
