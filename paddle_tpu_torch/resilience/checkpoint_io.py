"""Atomic, verified checkpoints — counterpart of
``paddle_tpu/resilience/checkpoint_io.py``, in the same format.

Each checkpoint is one ``save_dir/pass-%05d`` directory:

- **written atomically**: the npz files and ``manifest.json`` land in a
  dot-prefixed temp directory (invisible to ``latest_pass``), each file is
  fsynced, and one ``os.replace`` publishes the directory;
- **verified**: the manifest records a CRC32 of every stored array, its
  original dtype (npz has no bfloat16, see ``npz_safe``), its shape, the
  wall-clock time and the caller's metadata; ``load_checkpoint`` and
  ``latest_pass`` re-hash on read and refuse or skip corrupt directories;
- **bounded**: ``keep_last_n`` retention prunes the oldest pass dirs after
  each save, and sweeps temp dirs a crashed save left.

The array keys are the reference's ``jax.tree_util.keystr`` strings of the
same trees (``['slots']['_lstm0.w0'][0]``, ``['step']``): dicts flatten in
sorted key order, tuples and lists by index, ``None`` and ``()`` hold no
leaf.  So a checkpoint written by either package loads in the other.
Tensors are stored from the host; a load puts each leaf on the device of
the tree it is loaded into, with the manifest's dtype.

Not ported here: the gang commit barrier (``save_checkpoint(barrier=)``)
and the journal record of a skipped checkpoint wait for ROADMAP.md Queue 1
item 9.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import time
import uuid
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.resilience.errors import CheckpointError
from paddle_tpu_torch.utils.flags import FLAGS
from paddle_tpu_torch.utils.log import logger

__all__ = ["MANIFEST_VERSION", "QUARANTINE_MARKER", "npz_safe",
           "save_pytree", "load_pytree", "save_checkpoint",
           "load_checkpoint", "read_manifest", "validate_checkpoint",
           "quarantine_checkpoint", "quarantine_reason", "latest_pass",
           "latest_valid_pass", "prune_checkpoints", "pass_dir",
           "failing_member"]

MANIFEST_VERSION = 1

# pass ids render %05d but grow past 5 digits
_PASS_RE = re.compile(r"pass-(\d{5,})")

_TMP_PREFIX = ".tmp-"

#: a dir holding this file fails validation (the reference's scrubber
#: writes it into a dir whose payload no longer re-hashes)
QUARANTINE_MARKER = "QUARANTINED"

# a temp dir younger than this is an in-flight save of a concurrent writer
# and is left alone by prune_checkpoints; older ones are crash debris
_TMP_GRACE_S = 900.0


def pass_dir(save_dir: str, pass_id: int) -> str:
    return os.path.join(save_dir, f"pass-{pass_id:05d}")


# ---------------------------------------------------------------------------
# trees <-> npz with a verification manifest
# ---------------------------------------------------------------------------


def _dtype_name(leaf) -> str:
    if torch.is_tensor(leaf):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def npz_safe(a) -> np.ndarray:
    """A leaf as an array npz can hold: bfloat16 (which numpy lacks) is
    stored as float32, losslessly; the manifest keeps the original dtype."""
    if torch.is_tensor(a):
        t = a.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    arr = np.asarray(a)
    if arr.dtype.kind == "V" or arr.dtype.name not in np.sctypeDict:
        return arr.astype(np.float32)
    return arr


def _leaves(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr, leaf) in ``jax.tree_util.tree_flatten_with_path`` order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _rebuild(like, values: Dict[str, Any], path: str = ""):
    """``like``'s structure with each leaf replaced by ``values[keystr]``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, values, f"{path}[{k!r}]")
                for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, values, f"{path}[{i}]")
                          for i, v in enumerate(like))
    return values[path]


def save_pytree(path: str, tree: Any) -> Dict[str, Dict[str, Any]]:
    """Write one compressed npz; returns the manifest ``arrays`` section:
    per-key CRC32 of the stored bytes, original/stored dtype, shape."""
    flat = {key: (npz_safe(leaf), _dtype_name(leaf))
            for key, leaf in _leaves(tree)}
    np.savez_compressed(path, **{k: a for k, (a, _) in flat.items()})
    return {key: {"crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
                  "orig_dtype": orig, "stored_dtype": str(arr.dtype),
                  "shape": [int(d) for d in arr.shape]}
            for key, (arr, orig) in flat.items()}


def load_pytree(path: str, like: Any,
                dtypes: Optional[Dict[str, str]] = None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors): each
    leaf on its ``like`` leaf's device.  ``dtypes`` is the manifest's
    ``{key: orig_dtype}`` map; where present it wins over the dtype of the
    ``like`` leaf."""
    values = {}
    with np.load(path, allow_pickle=False) as data:
        for key, leaf in _leaves(like):
            if key not in data:
                raise KeyError(f"checkpoint missing {key}")
            target = (dtypes or {}).get(key)
            values[key] = torch.from_numpy(data[key]).to(
                device=leaf.device,
                dtype=getattr(torch, target) if target else leaf.dtype)
    return _rebuild(like, values)


# ---------------------------------------------------------------------------
# atomic save
# ---------------------------------------------------------------------------


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems refuse directory fsync
    finally:
        os.close(fd)


def save_checkpoint(save_dir: str, pass_id: int, *, params, state=None,
                    opt_state=None, extra: Optional[Dict[str, Any]] = None,
                    meta: Optional[dict] = None,
                    keep_last_n: Optional[int] = None) -> str:
    """Atomically write ``save_dir/pass-%05d``.

    ``extra`` maps extra npz file stems to trees (e.g. averaged params);
    ``meta`` lands verbatim under manifest ``meta``; ``keep_last_n``
    (default ``FLAGS.keep_last_n``; 0 = unlimited) prunes the oldest pass
    dirs after the save.  An existing dir of the same pass is moved aside
    before the rename and removed only after the new one is in place, so
    a crash never destroys the only checkpoint."""
    if keep_last_n is None:
        keep_last_n = FLAGS.keep_last_n
    os.makedirs(save_dir, exist_ok=True)
    final = pass_dir(save_dir, pass_id)
    tmp = os.path.join(
        save_dir, f"{_TMP_PREFIX}pass-{pass_id:05d}-{uuid.uuid4().hex[:8]}")
    os.makedirs(tmp)
    aside = None
    try:
        files: Dict[str, Dict[str, Any]] = {}
        trees = {"params.npz": params}
        if state is not None:
            trees["state.npz"] = state
        if opt_state is not None:
            trees["opt_state.npz"] = opt_state
        for stem, tree in (extra or {}).items():
            trees[f"{stem}.npz"] = tree
        for fname, tree in trees.items():
            fpath = os.path.join(tmp, fname)
            files[fname] = {"arrays": save_pytree(fpath, tree)}
            _fsync_file(fpath)
        manifest = {
            "version": MANIFEST_VERSION,
            "pass_id": pass_id,
            "time": time.time(),
            "has_state": state is not None,
            "has_opt": opt_state is not None,
            "files": files,
            "meta": dict(meta or {}),
        }
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        if os.path.isdir(final):
            aside = os.path.join(
                save_dir,
                f"{_TMP_PREFIX}old-{pass_id:05d}-{uuid.uuid4().hex[:8]}")
            os.replace(final, aside)
        os.replace(tmp, final)
        _fsync_dir(save_dir)
        if aside is not None:
            shutil.rmtree(aside, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        if aside is not None and not os.path.isdir(final):
            os.replace(aside, final)  # put the previous checkpoint back
        raise
    if keep_last_n and keep_last_n > 0:
        prune_checkpoints(save_dir, keep_last_n)
    return final


def _newest_mtime(tmp_dir: str) -> float:
    """Freshest mtime of a temp dir or anything inside it (a writer
    streaming one large npz moves the file's mtime, not the dir's)."""
    newest = os.path.getmtime(tmp_dir)
    try:
        with os.scandir(tmp_dir) as it:
            for entry in it:
                try:
                    newest = max(newest, entry.stat().st_mtime)
                except OSError:
                    continue
    except OSError:
        pass
    return newest


def prune_checkpoints(save_dir: str, keep_last_n: int) -> List[str]:
    """Delete all but the newest ``keep_last_n`` pass dirs (by pass id)
    and temp dirs older than the grace window; returns removed paths.
    Every stat/remove tolerates a concurrent pruner."""
    removed = []
    try:
        names = os.listdir(save_dir)
    except OSError:
        return removed
    ids = []
    now = time.time()
    for name in names:
        m = _PASS_RE.fullmatch(name)
        if m:
            ids.append(int(m.group(1)))
        elif name.startswith(_TMP_PREFIX):
            p = os.path.join(save_dir, name)
            try:
                if now - _newest_mtime(p) < _TMP_GRACE_S:
                    continue  # a concurrent save owns this dir
            except OSError:
                continue      # vanished under us
            shutil.rmtree(p, ignore_errors=True)
            removed.append(p)
    for pid in sorted(ids)[:-keep_last_n] if keep_last_n > 0 else []:
        p = pass_dir(save_dir, pid)
        shutil.rmtree(p, ignore_errors=True)
        removed.append(p)
    return removed


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------


def read_manifest(ckpt_dir: str) -> Dict[str, Any]:
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        return json.load(f)


def validate_checkpoint(ckpt_dir: str, *, verify_crc: bool = True
                        ) -> Optional[str]:
    """None if the checkpoint is loadable, else a reason.  A legacy
    directory (no ``files`` section in its manifest) is accepted when its
    ``params.npz`` parses; it cannot be CRC-verified."""
    if not os.path.isdir(ckpt_dir):
        return "not a directory"
    q = quarantine_reason(ckpt_dir)
    if q is not None:
        return q
    try:
        manifest = read_manifest(ckpt_dir)
    except FileNotFoundError:
        return "missing manifest.json"
    except (json.JSONDecodeError, OSError) as e:
        return f"unreadable manifest.json: {e}"
    files = manifest.get("files")
    if files is None:  # legacy format: best effort
        ppath = os.path.join(ckpt_dir, "params.npz")
        if not os.path.exists(ppath):
            return "missing params.npz"
        try:
            with np.load(ppath, allow_pickle=False):
                pass
        except Exception as e:  # noqa: BLE001 — the reason is the result
            return f"params.npz unreadable: {type(e).__name__}: {e}"
        return None
    for fname, info in files.items():
        fpath = os.path.join(ckpt_dir, fname)
        if not os.path.exists(fpath):
            return f"missing {fname}"
        if not verify_crc:
            continue
        reason = _verify_file(fpath, fname, info.get("arrays", {}))
        if reason is not None:
            return reason
    return None


def _verify_file(fpath: str, fname: str, arrays: Dict[str, Any]
                 ) -> Optional[str]:
    """None if every array the manifest lists re-hashes to its CRC."""
    try:
        data = np.load(fpath, allow_pickle=False)
    except Exception as e:  # noqa: BLE001 — the reason is the result
        return f"{fname} unreadable: {type(e).__name__}: {e}"
    with data:
        for key, entry in arrays.items():
            if key not in data.files:
                return f"{fname} missing array {key}"
            try:
                arr = data[key]
            except Exception as e:  # noqa: BLE001 — the reason is the result
                return f"{fname}:{key} undecodable: {type(e).__name__}: {e}"
            crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
            if crc != entry.get("crc32"):
                return (f"{fname}:{key} CRC mismatch "
                        f"({crc:#x} != {entry.get('crc32', 0):#x})")
    return None


def quarantine_checkpoint(ckpt_dir: str, reason: str) -> None:
    """Drop ``ckpt_dir`` out of ``latest_pass`` eligibility without
    destroying it: a marker file that validation refuses from then on."""
    tmp = os.path.join(ckpt_dir,
                       f".{QUARANTINE_MARKER}-{uuid.uuid4().hex[:8]}")
    try:
        with open(tmp, "w") as f:
            json.dump({"reason": reason, "time": time.time()}, f)
        os.replace(tmp, os.path.join(ckpt_dir, QUARANTINE_MARKER))
    except OSError as e:
        logger.warning("could not quarantine %s: %s", ckpt_dir, e)


def quarantine_reason(d: str) -> Optional[str]:
    """The validation reason for a quarantined dir, or ``None``."""
    qpath = os.path.join(d, QUARANTINE_MARKER)
    if not os.path.exists(qpath):
        return None
    try:
        with open(qpath) as f:
            why = json.load(f).get("reason", "")
    except (OSError, json.JSONDecodeError, ValueError):
        why = ""
    return "quarantined by scrubber" + (f": {why}" if why else "")


def failing_member(reason: str) -> str:
    """Best-effort extraction of the file/member a validation reason names
    ('params.npz:KEY CRC mismatch' -> 'params.npz'), for journal records;
    '' when no member is identifiable."""
    if not reason:
        return ""
    toks = reason.split()
    if toks[0] == "missing" and len(toks) > 1:
        return toks[1]
    if "." in toks[0]:
        return toks[0].split(":", 1)[0]
    return ""


def latest_pass(save_dir: str, *, validate: bool = True) -> int:
    """Highest pass id with a valid checkpoint under save_dir, or -1.
    Corrupt directories are logged and skipped, so resume lands on the
    newest checkpoint that will load."""
    if not os.path.isdir(save_dir):
        return -1
    ids = [int(m.group(1)) for m in map(_PASS_RE.fullmatch,
                                          os.listdir(save_dir)) if m]
    for pid in sorted(ids, reverse=True):
        if not validate:
            return pid
        reason = validate_checkpoint(pass_dir(save_dir, pid))
        if reason is None:
            return pid
        logger.warning("skipping corrupt checkpoint %s: %s",
                       pass_dir(save_dir, pid), reason)
        # the read path's skip lands in the journal with the failing
        # member named, so a postmortem sees WHEN a checkpoint went bad
        # (a no-op without --obs_journal)
        from paddle_tpu_torch.obs.journal import journal_event

        journal_event("ckpt_quarantined", dir=pass_dir(save_dir, pid),
                      member=failing_member(reason), reason=reason)
    return -1


def latest_valid_pass(save_dir: str) -> int:
    """``latest_pass(validate=True)``, spelled out."""
    return latest_pass(save_dir, validate=True)


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------


def _file_dtypes(manifest: Dict[str, Any], fname: str
                 ) -> Optional[Dict[str, str]]:
    info = (manifest.get("files") or {}).get(fname)
    if not info:
        return None
    return {k: v["orig_dtype"] for k, v in info.get("arrays", {}).items()
            if "orig_dtype" in v}


def load_checkpoint(save_dir: str, pass_id: int, *, params, state=None,
                    opt_state=None,
                    extra_like: Optional[Dict[str, Any]] = None,
                    validate: bool = True):
    """Validate and restore ``pass-%05d``; raises ``CheckpointError`` when
    the directory fails verification.  Returns ``(params, state,
    opt_state)``, plus a ``{stem: tree}`` dict when ``extra_like`` names
    extra files.  ``validate=False`` skips the CRC pass for a caller that
    just validated."""
    d = pass_dir(save_dir, pass_id)
    if validate:
        reason = validate_checkpoint(d)
        if reason is not None:
            raise CheckpointError(
                f"checkpoint {d} failed validation: {reason}")
    try:
        manifest = read_manifest(d)
    except FileNotFoundError:
        manifest = {}

    def load(stem, like):
        return load_pytree(os.path.join(d, f"{stem}.npz"), like,
                           dtypes=_file_dtypes(manifest, f"{stem}.npz"))

    out_params = load("params", params)
    out_state, out_opt = state, opt_state
    if state is not None and os.path.exists(os.path.join(d, "state.npz")):
        out_state = load("state", state)
    if opt_state is not None and os.path.exists(
            os.path.join(d, "opt_state.npz")):
        out_opt = load("opt_state", opt_state)
    if extra_like is None:
        return out_params, out_state, out_opt
    extras = {stem: load(stem, like) for stem, like in extra_like.items()
              if os.path.exists(os.path.join(d, f"{stem}.npz"))}
    return out_params, out_state, out_opt, extras
