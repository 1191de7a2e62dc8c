"""Deploy bundles — counterpart of ``paddle_tpu/config/deploy.py`` (the
reference's MergeModel and its C API inference path).

A bundle is one ``.ptz`` zip: ``manifest.json``, ``model.pb`` (the binary
ModelConfig of ``paddle_tpu_torch/proto``), ``params.npz`` and, where the
model has state, ``state.npz``.  The format is the reference's: a bundle
merged by either package loads in the other.  ``InferenceModel`` rebuilds
the Topology from the proto (no model code needed), keeps the parameters
resident on its device (``cuda`` unless the caller asks otherwise) and
serves the forward.

Quantized exports (``merge_model(quantize=...)``) store bfloat16 bits or
per-channel int8 with their scales; the stored bytes are computed in numpy
and equal the reference's bit for bit (bfloat16 rounds to nearest even by
integer arithmetic on the float32 bits, NaN and infinities included).
Every quantized export passes a max-abs-error gate against the float32
forward before it is written; the loader dequantizes to float32.

``InferenceModel.prime(feed, cache=)`` is the warmup unit against a compile
cache (``config/compile_cache.py``): the kernel libraries the signature's
forward runs are loaded from the cache or built and stored.
``load_inference_model(arch_fingerprint=True)`` gives the model the
architecture identity every weight version of it shares (the config proto
and the parameters' names, shapes and dtypes), equal to the JAX package's
for the same bundle.

Not ported yet; each raises a ``ConfigError`` naming its ROADMAP.md Queue 1
item: ``load_inference_model(int8_in_trace=True)`` (its admission gate is a
jaxpr audit) and ``merge_model(example_feed=)`` (the deploy lint), item 9.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import threading
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.config.config_parser import (build_topology,
                                                   dump_model_config)
from paddle_tpu_torch.nn.graph import Topology
from paddle_tpu_torch.proto import model_config_pb2 as pb
from paddle_tpu_torch.resilience.checkpoint_io import npz_safe
from paddle_tpu_torch.utils.error import not_ported
from paddle_tpu_torch.utils.log import logger

__all__ = ["merge_model", "InferenceModel", "load_inference_model",
           "BundleCorruptError", "quantize_params", "feed_signature"]

_MAGIC = "paddle_tpu.bundle.v1"


class BundleCorruptError(RuntimeError):
    """A ``.ptz`` bundle failed integrity validation: not a zip, a member
    missing, a member's CRC or compressed stream damaged, or a payload that
    does not parse.  ``member`` names the failing zip member (None when the
    archive itself is unreadable)."""

    def __init__(self, message: str, *, path: str = "",
                 member: Optional[str] = None) -> None:
        super().__init__(message)
        self.path = path
        self.member = member


def _npz_bytes(tree: Dict[str, Any]) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **{k: npz_safe(v) for k, v in tree.items()})
    return buf.getvalue()


def _raw_npz_bytes(tree: Dict[str, np.ndarray]) -> bytes:
    """Quantized trees are already npz-storable (int8, uint16 bits, f32)."""
    buf = io.BytesIO()
    np.savez_compressed(buf, **tree)
    return buf.getvalue()


def _npz_load(data: bytes) -> Dict[str, np.ndarray]:
    return dict(np.load(io.BytesIO(data), allow_pickle=False))


# ---------------------------------------------------------------------------
# weight quantization — the bundle's export modes
# ---------------------------------------------------------------------------

_QUANT_MODES = ("bf16", "int8")
#: scale arrays ride the SAME npz as their quantized array, keyed by suffix
_SCALE_SUFFIX = "::scale"
#: int8 only for matmul-sized tensors; smaller floats (biases, gains, BN
#: statistics) go bf16
_INT8_MIN_SIZE = 256


def _bf16_bits(a: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits (uint16), rounded to nearest even; a NaN
    becomes the quiet NaN of its sign (0x7FC0 / 0xFFC0), as ``ml_dtypes``
    converts."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    rounded = (u + (((u >> 16) & 1) + 0x7FFF)) >> 16
    nan_bits = np.where(u >> 31, 0xFFC0, 0x7FC0)
    return np.where(np.isnan(a), nan_bits, rounded).astype(np.uint16)


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def quantize_params(params: Dict[str, Any], mode: str):
    """Quantize a parameter tree for bundle storage.

    ``mode="bf16"`` stores every floating array as bfloat16 raw bits
    (uint16 in the npz); ``mode="int8"`` also stores matmul-sized floats
    (ndim >= 2, size >= 256) as symmetric per-channel int8,
    ``q = round(w / scale)`` clipped to [-127, 127] with
    ``scale = maxabs_channel / 127`` over the LAST axis, the scale stored
    beside it as ``<name>::scale``.  Integer arrays pass through.  Returns
    ``(stored, qmeta)``, ``qmeta`` being the manifest's per-array recipe."""
    if mode not in _QUANT_MODES:
        raise ValueError(f"quantize mode must be one of {_QUANT_MODES}, "
                         f"got {mode!r}")
    stored: Dict[str, np.ndarray] = {}
    qmeta: Dict[str, dict] = {}
    for name, v in params.items():
        if _SCALE_SUFFIX in name:
            raise ValueError(f"parameter name {name!r} collides with the "
                             f"quantization scale suffix")
        orig = (str(v.dtype).replace("torch.", "") if torch.is_tensor(v)
                else str(np.asarray(v).dtype))
        arr = npz_safe(v)
        if arr.dtype.kind != "f":
            stored[name] = arr  # integer / bool arrays pass through
            continue
        a = np.asarray(arr, dtype=np.float32)
        if mode == "int8" and a.ndim >= 2 and a.size >= _INT8_MIN_SIZE:
            absmax = np.max(np.abs(a), axis=tuple(range(a.ndim - 1)),
                            keepdims=True)
            scale = (absmax / 127.0).astype(np.float32)
            scale[scale == 0.0] = 1.0  # all-zero channels: q=0, any scale
            stored[name] = np.clip(np.round(a / scale), -127, 127
                                   ).astype(np.int8)
            stored[name + _SCALE_SUFFIX] = scale
            qmeta[name] = {"mode": "int8", "orig_dtype": orig}
        else:
            stored[name] = _bf16_bits(a)
            qmeta[name] = {"mode": "bf16", "orig_dtype": orig}
    return stored, qmeta


def _dequantize_params(raw: Dict[str, np.ndarray], qmeta: Dict[str, dict],
                       *, path: str = "", member: str = "params.npz"
                       ) -> Dict[str, np.ndarray]:
    """Stored npz dict -> f32 arrays, validating every quantized array's
    recipe: a missing, mis-shaped or non-finite scale raises a
    :class:`BundleCorruptError` naming the failing member."""
    out: Dict[str, np.ndarray] = {}
    for name, arr in raw.items():
        if name.endswith(_SCALE_SUFFIX):
            continue
        meta = qmeta.get(name)
        if meta is None:
            out[name] = arr
            continue
        mode = meta.get("mode")
        if mode == "bf16":
            if arr.dtype != np.uint16:
                raise BundleCorruptError(
                    f"bundle {path!r}: bf16-quantized array {name!r} stored "
                    f"as {arr.dtype} (expected uint16 raw bits)",
                    path=path, member=f"{member}:{name}")
            out[name] = _bf16_to_f32(arr)
        elif mode == "int8":
            sname = name + _SCALE_SUFFIX
            smember = f"{member}:{sname}"
            scale = raw.get(sname)
            if scale is None:
                raise BundleCorruptError(
                    f"bundle {path!r}: int8-quantized array {name!r} is "
                    f"missing its scale member {sname!r}",
                    path=path, member=smember)
            if (scale.dtype != np.float32 or scale.ndim != arr.ndim
                    or scale.shape[-1] != arr.shape[-1]
                    or any(d != 1 for d in scale.shape[:-1])):
                raise BundleCorruptError(
                    f"bundle {path!r}: scale member {sname!r} has "
                    f"shape {scale.shape} dtype {scale.dtype} — expected "
                    f"f32 {(1,) * (arr.ndim - 1) + (arr.shape[-1],)}",
                    path=path, member=smember)
            if not np.all(np.isfinite(scale)) or np.any(scale <= 0):
                raise BundleCorruptError(
                    f"bundle {path!r}: scale member {sname!r} carries "
                    f"non-finite or non-positive values",
                    path=path, member=smember)
            if arr.dtype != np.int8:
                raise BundleCorruptError(
                    f"bundle {path!r}: int8-quantized array {name!r} "
                    f"stored as {arr.dtype}",
                    path=path, member=f"{member}:{name}")
            out[name] = arr.astype(np.float32) * scale
        else:
            raise BundleCorruptError(
                f"bundle {path!r}: unknown quantize mode {mode!r} for "
                f"array {name!r}", path=path, member=f"{member}:{name}")
    return out


def _on_device(tree: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """Float arrays as float32 tensors on ``device`` (integers kept)."""
    out = {}
    for k, v in tree.items():
        t = torch.as_tensor(npz_safe(v))
        out[k] = (t.float() if t.is_floating_point() else t).to(device)
    return out


def _quant_error_gate(topology: Topology, params, deq, state,
                      outs: List[str], tol: float, mode: str) -> float:
    """Max-abs-error of the dequantized forward against the f32 one over a
    seeded synthetic feed sweep; every quantized export passes it before
    the bundle is written."""
    from paddle_tpu_torch.nn.feeds import example_feed

    dev = topology.device
    ref_p, got_p = _on_device(params, dev), _on_device(deq, dev)
    st = _on_device(state or {}, dev)
    worst = 0.0
    with torch.no_grad():
        for i in range(3):
            feed = example_feed(topology, batch=2,
                                rng=np.random.RandomState(i))
            ref, _ = topology.apply(ref_p, st, feed, train=False,
                                    outputs=outs)
            got, _ = topology.apply(got_p, st, feed, train=False,
                                    outputs=outs)
            for n in outs:
                err = (ref[n].value.float() - got[n].value.float()).abs()
                worst = max(worst, float(err.max()) if err.numel() else 0.0)
    if not np.isfinite(worst) or worst > tol:
        raise ValueError(
            f"quantize={mode!r} export rejected: max abs output error "
            f"{worst:.4g} vs the f32 oracle exceeds tolerance {tol:g} "
            f"over the synthetic sweep — this model does not survive "
            f"{mode} weights (raise quantize_tol only if the serving "
            f"consumer tolerates it)")
    return worst


def feed_signature(feed: Dict[str, Any]) -> tuple:
    """Canonical (hashable) shape+dtype signature of a feed.  Tuple feeds
    keep their arity so ``(values,)`` never aliases a bare array."""
    sig = []
    for k in sorted(feed):
        v = feed[k]
        parts = v if isinstance(v, tuple) else (v,)
        sig.append((k, len(parts) if isinstance(v, tuple) else 0,
                    tuple((tuple(p.shape), _dtype_name(p)) for p in
                          (p if torch.is_tensor(p) else np.asarray(p)
                           for p in parts))))
    return tuple(sig)


def _dtype_name(a) -> str:
    return str(a.dtype).replace("torch.", "")


def merge_model(path: str, topology: Topology, params: Dict[str, Any],
                state: Optional[Dict[str, Any]] = None, *,
                name: str = "model", meta: Optional[dict] = None,
                example_feed: Optional[Dict[str, Any]] = None,
                quantize: Optional[str] = None,
                quantize_tol: float = 0.05) -> str:
    """Write config + parameters as one deployable file.

    ``quantize`` (``None`` reads ``--deploy_quantize``): ``"bf16"`` halves
    the weight payload, ``"int8"`` stores matmul-sized tensors as symmetric
    per-channel int8 (~4x smaller) with their scales alongside.  Every
    quantized export is gated: the dequantized forward must stay within
    ``quantize_tol`` max-abs output error of the f32 forward over a seeded
    synthetic feed sweep (run on the topology's device), or the export
    raises instead of writing the bundle."""
    if example_feed is not None:
        raise not_ported("merge_model(example_feed=) (the deploy lint)", 9)
    if quantize is None:
        from paddle_tpu_torch.utils.flags import FLAGS

        quantize = FLAGS.deploy_quantize or None
    if quantize is not None and quantize not in _QUANT_MODES:
        raise ValueError(f"quantize must be one of {_QUANT_MODES} (or "
                         f"None/'' for f32), got {quantize!r}")
    mc = dump_model_config(topology, name)
    need = {n for n, s in topology.param_specs.items() if not s.is_state}
    missing = sorted(need - set(params))
    if missing:
        raise ValueError(f"merge_model: params dict is missing {missing}")
    need_state = {n for n, s in topology.param_specs.items() if s.is_state}
    missing_state = sorted(need_state - set(state or {}))
    if missing_state:
        raise ValueError(f"merge_model: state dict is missing {missing_state}")
    manifest = {
        **(meta or {}),
        # reserved keys win over user meta
        "magic": _MAGIC,
        "name": name,
        "outputs": list(mc.output_layer_names),
        "inputs": list(mc.input_layer_names),
    }
    if quantize is not None:
        stored, qmeta = quantize_params(params, quantize)
        # gate against the SAME dequantization the loader runs
        deq = _dequantize_params(stored, qmeta)
        err = _quant_error_gate(topology, params, deq, state,
                                list(mc.output_layer_names), quantize_tol,
                                quantize)
        manifest["quantize"] = {"mode": quantize, "tol": quantize_tol,
                                "max_abs_err": round(err, 8),
                                "arrays": qmeta}
        params_bytes = _raw_npz_bytes(stored)
    else:
        params_bytes = _npz_bytes(params)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("manifest.json", json.dumps(manifest, indent=1))
        z.writestr("model.pb", mc.SerializeToString())
        z.writestr("params.npz", params_bytes)
        if state:
            z.writestr("state.npz", _npz_bytes(state))
    return path


def _host(v) -> np.ndarray:
    if torch.is_tensor(v):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


class InferenceModel:
    """A model rebuilt from its config proto, serving forward passes with
    its parameters resident on ``device`` (``cuda`` unless the caller asks
    otherwise).

    ``infer`` needs only the data layers reachable from the requested
    outputs, and answers a zero-row request with correctly shaped empty
    arrays: from the outputs of a primed call of the same per-row shapes,
    or else from a one-row pass.  ``prime`` makes one warm call per feed
    signature, against a compile cache when given; ``compile_events`` counts
    the ones the cache did not serve.  ``fingerprint`` is the bundle's
    payload CRCs or, with ``arch_fingerprint=True`` (or a model built
    in-process), the architecture: the config proto and the parameters'
    names, shapes and dtypes."""

    def __init__(self, mc: pb.ModelConfig, params, state, manifest: dict, *,
                 fingerprint: Optional[str] = None, device=None):
        self.model_config = mc
        self.topology = build_topology(mc, device=device)
        self.device = self.topology.device
        self.manifest = manifest
        if mc.dtype_policy:
            from paddle_tpu_torch.config.config_parser import _policy_name

            local = _policy_name()
            if local != mc.dtype_policy:
                logger.warning(
                    "model bundle %r was exported under compute_dtype=%s but "
                    "this process uses %s — predictions may differ from "
                    "training; set FLAGS.compute_dtype=%r to match",
                    manifest.get("name", "?"), mc.dtype_policy, local,
                    mc.dtype_policy)
        specs = self.topology.param_specs
        want_p = {n: s for n, s in specs.items() if not s.is_state}
        want_s = {n: s for n, s in specs.items() if s.is_state}
        missing = sorted(set(want_p) - set(params))
        if missing:
            raise ValueError(
                f"model bundle is missing parameters {missing} — was it "
                "written by an older/incompatible build?")
        missing_state = sorted(set(want_s) - set(state))
        if missing_state:
            raise ValueError(
                f"model bundle is missing state arrays {missing_state}")
        for n, s in specs.items():
            got = tuple(np.shape((params if n in want_p else state)[n]))
            if got != tuple(s.shape):
                raise ValueError(f"model bundle array {n!r} has shape {got}"
                                 f", the config says {tuple(s.shape)}")
        # resident across infer() calls, in the topology's init dtype
        self.params = _on_device({n: params[n] for n in want_p}, self.device)
        self.state = _on_device({n: state[n] for n in want_s}, self.device)
        if fingerprint is None:
            h = hashlib.sha256(mc.SerializeToString())
            for k in sorted(self.params):
                a = self.params[k]
                h.update(f"{k}:{tuple(a.shape)}:{_dtype_name(a)}".encode())
            fingerprint = h.hexdigest()[:32]
        self.fingerprint = fingerprint
        #: the artifact the model was loaded from (set by
        #: load_inference_model; empty for models built in-process)
        self.bundle_path = ""
        #: warm calls the compile cache did not serve: ``"compiled"`` and
        #: ``"miss"`` (the reference counts its XLA compiles the same way)
        self.compile_events = 0
        self._primed: set = set()
        #: required input slots per output tuple (the walk is a function of
        #: the names; the serving hot path must not re-walk the graph)
        self._needed_slots: Dict[tuple, frozenset] = {}
        #: zero-row replies per (names, per-row feed shapes)
        self._empty_cache: Dict[tuple, Dict[str, np.ndarray]] = {}
        self._lock = threading.Lock()

    @property
    def input_names(self) -> List[str]:
        return list(self.model_config.input_layer_names)

    @property
    def output_names(self) -> List[str]:
        return list(self.model_config.output_layer_names)

    def _names(self, outputs) -> tuple:
        return tuple(outputs) if outputs else tuple(self.output_names)

    def _check_feed(self, feed: Dict[str, Any], names: tuple) -> None:
        # only the data layers REACHABLE from the requested outputs are
        # required (a classifier bundle serves 'out' without its 'label')
        need = self._needed_slots.get(names)
        if need is None:
            needed = self.topology._needed_layers(set(names))
            need = frozenset(l.name for l in needed if l.is_data)
            self._needed_slots[names] = need
        missing = sorted(need - set(feed))
        if missing:
            raise ValueError(
                f"feed is missing input slot(s) {missing}; outputs "
                f"{list(names)} need inputs {sorted(need)}")

    def _make_run(self, names: tuple):
        topology = self.topology

        def run(params, state, feed):
            outs, _ = topology.apply(params, state, feed, train=False,
                                     outputs=list(names))
            return {n: outs[n].value for n in names}

        return run

    def _run(self, names: tuple, feed) -> Dict[str, np.ndarray]:
        with torch.no_grad():
            res = self._make_run(names)(self.params, self.state, feed)
        return {k: _host(v) for k, v in res.items()}

    @staticmethod
    def _row_key(names: tuple, feed: Dict[str, Any]) -> tuple:
        """(names, per-row shapes and dtypes): what the zero-row reply's
        shapes depend on."""
        return (names, tuple(
            (k, isinstance(v, tuple))
            + tuple((tuple(np.shape(p))[1:],
                     _dtype_name(p if torch.is_tensor(p) else np.asarray(p)))
                    for p in (v if isinstance(v, tuple) else (v,)))
            for k, v in sorted(feed.items())))

    def _note_empty(self, key: tuple, res: Dict[str, np.ndarray]) -> None:
        if len(self._empty_cache) >= 64:
            # keys are client-controlled (per-row shapes): bounded
            self._empty_cache.clear()
        self._empty_cache[key] = {
            k: np.zeros(((0,) + a.shape[1:]) if a.shape else a.shape,
                        a.dtype) for k, a in res.items()}

    def prime(self, feed: Dict[str, Any],
              outputs: Optional[Sequence[str]] = None, cache=None) -> str:
        """One warm call for this feed's signature, the warmup unit of the
        serving readiness gate.  Its outputs also give the zero-row reply
        for the feed's per-row shapes.  Returns ``"warm"`` (primed before),
        ``"compiled"`` (no ``cache``, or a call that ran no cacheable kernel
        library — on the CPU the plain versions run and the cache has
        nothing to give), or with a compile ``cache``
        (``config/compile_cache.py``) ``"hit"`` — every kernel library the
        call ran came from the cache, or the cache already held it — or
        ``"miss"`` — a library was built and stored.  A library loaded from
        the cache passed its smoke call first."""
        names = self._names(outputs)
        self._check_feed(feed, names)
        k = (names, feed_signature(feed))
        if k in self._primed:
            return "warm"
        if cache is None:
            res = self._run(names, feed)
            result = "compiled"
        else:
            from paddle_tpu_torch.config.compile_cache import priming

            with priming(cache) as counts:
                res = self._run(names, feed)
            result = ("compiled" if not counts["libraries"] else
                      "miss" if counts["misses"] else "hit")
        with self._lock:
            self._note_empty(self._row_key(names, feed), res)
            self._primed.add(k)
            if result != "hit":
                self.compile_events += 1
        return result

    def infer(self, feed: Dict[str, Any],
              outputs: Optional[Sequence[str]] = None
              ) -> Dict[str, np.ndarray]:
        names = self._names(outputs)
        self._check_feed(feed, names)
        rows = {np.shape(p)[0] if len(np.shape(p)) else -1
                for v in feed.values()
                for p in (v if isinstance(v, tuple) else (v,))}
        if 0 not in rows:
            return self._run(names, feed)
        if rows != {0}:
            # a zero-row part next to populated parts is a client bug, not
            # an empty request
            raise ValueError(
                f"feed mixes zero-row and populated inputs (batch sizes "
                f"{sorted(rows)}); an empty request must be empty in every "
                f"slot")
        key = self._row_key(names, feed)
        res = self._empty_cache.get(key)
        if res is None:
            from paddle_tpu_torch.nn.feeds import zero_batch_like

            one = self._run(names, zero_batch_like(feed))
            with self._lock:
                self._note_empty(key, one)
                res = self._empty_cache[key]
        return {k: v.copy() for k, v in res.items()}


def _read_member(z: zipfile.ZipFile, path: str, name: str) -> bytes:
    """One zip member, with the failing member named: a missing member, a
    bad CRC (``zipfile`` checks it on every full read) or a torn compressed
    stream raises ``BundleCorruptError``."""
    try:
        return z.read(name)
    except KeyError:
        raise BundleCorruptError(
            f"bundle {path!r} is missing member {name!r} (truncated or "
            f"damaged archive?)", path=path, member=name) from None
    except (zipfile.BadZipFile, zlib.error, EOFError) as e:
        raise BundleCorruptError(
            f"bundle {path!r} member {name!r} is corrupt: {e}",
            path=path, member=name) from e


def _load_npz_member(z, path: str, name: str) -> Dict[str, np.ndarray]:
    data = _read_member(z, path, name)
    try:
        return _npz_load(data)
    except Exception as e:  # np.load on a damaged npz payload
        raise BundleCorruptError(
            f"bundle {path!r} {name} does not parse: {e}",
            path=path, member=name) from e


def load_inference_model(path: str, *, device=None,
                         int8_in_trace: bool = False,
                         arch_fingerprint: bool = False) -> InferenceModel:
    """Load a ``.ptz`` bundle into a servable :class:`InferenceModel` on
    ``device`` (``cuda`` unless the caller asks otherwise).

    Quantized bundles dequantize on load to float32.  The fingerprint is
    the zip CRCs of ``model.pb`` and ``params.npz`` (two bundles with
    identical payloads share it); ``arch_fingerprint=True`` makes it the
    architecture's instead (the config proto and the parameters' names,
    shapes and dtypes), which every weight version of one model shares —
    the hot-swap path keys versions by it (``serving/reload.py``)."""
    if int8_in_trace:
        raise not_ported("load_inference_model(int8_in_trace=True) (its "
                         "admission gate is a trace audit)", 9)
    try:
        zf = zipfile.ZipFile(path, "r")
    except FileNotFoundError:
        raise  # a missing file is not a corrupt one
    except (zipfile.BadZipFile, OSError) as e:
        raise BundleCorruptError(
            f"{path!r} is not a readable zip archive: {e}", path=path) from e
    with zf as z:
        try:
            manifest = json.loads(_read_member(z, path, "manifest.json"))
        except json.JSONDecodeError as e:
            raise BundleCorruptError(
                f"bundle {path!r} manifest.json does not parse: {e}",
                path=path, member="manifest.json") from e
        if not isinstance(manifest, dict) or manifest.get("magic") != _MAGIC:
            raise ValueError(f"{path!r} is not a paddle_tpu model bundle")
        mc = pb.ModelConfig()
        data = _read_member(z, path, "model.pb")
        try:
            mc.ParseFromString(data)
        except Exception as e:
            raise BundleCorruptError(
                f"bundle {path!r} model.pb does not parse: {e}",
                path=path, member="model.pb") from e
        params = _load_npz_member(z, path, "params.npz")
        state = (_load_npz_member(z, path, "state.npz")
                 if "state.npz" in z.namelist() else {})
        crcs = {i.filename: i.CRC for i in z.infolist()}
    fp = None if arch_fingerprint else "bundle:" + "-".join(
        f"{crcs.get(m, 0):08x}" for m in ("model.pb", "params.npz"))
    qmeta = (manifest.get("quantize") or {}).get("arrays") or {}
    if qmeta:
        params = _dequantize_params(params, qmeta, path=path)
    model = InferenceModel(mc, params, state, manifest, fingerprint=fp,
                           device=device)
    model.bundle_path = path
    return model
