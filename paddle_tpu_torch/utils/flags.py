"""The port's settings — counterpart of ``paddle_tpu/utils/flags.py``.

A typed flag registry (the reference's gflags plane): ``define_flag``
registers a flag, ``parse_flags`` reads ``--name=value`` / ``--name value``
from argv, ``FLAGS.name`` reads a value.  The port reads its own settings,
never the JAX package's flags or its environment variables: a flag's
environment override is ``PADDLE_TPU_TORCH_<NAME>`` (so
``PADDLE_TPU_TORCH_COMPUTE_DTYPE`` sets the compute dtype at import, the
reference's ``PADDLE_TPU_COMPUTE_DTYPE`` analogue).  ``Flags()`` is a
fresh store holding every registered flag's default.

Only the flags of ported parts are defined.  The command line
(``paddle_tpu_torch/__main__.py``) refuses the reference's other flags with
a ``ConfigError`` naming the ROADMAP.md Queue 1 item that ports them
(``NOT_PORTED_FLAGS``).

No flag chooses a plain version: on the card a kernel always runs, and on
the CPU its plain PyTorch version runs.  ``fused_bigru`` (the reference's
``use_pallas_bigru``, off by default as there) chooses between two kernel
paths for a bidirectional GRU layer: two one-direction loops (K3/K4) or one
loop over both directions (K11).  The reference's other conditions for its
fused path (``use_pallas_rnn``, the TPU backend, ``H % 128``, ``2B % 8``,
the VMEM cap) are TPU rules and are not ported: the port's kernel takes
any B and H.  ``max_gen_length`` is not here: no module of either package
reads it.  ``fused_apply`` is accepted for the reference's sake; the
port's optimizers run the per-leaf loop either way (the values are the
fused apply's, elementwise).
"""

from __future__ import annotations

import os
import sys
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

__all__ = ["FLAGS", "Flags", "define_flag", "parse_flags", "flags_help",
           "refuse_unparsed", "flag_part", "NOT_PORTED_FLAGS"]

_ENV_PREFIX = "PADDLE_TPU_TORCH_"


@dataclass
class _FlagSpec:
    name: str
    default: Any
    help: str
    type: type
    validator: Optional[Callable[[Any], bool]] = None


_SPECS: Dict[str, _FlagSpec] = {}
_LOCK = threading.Lock()


def _coerce(value: Any, typ: type) -> Any:
    if isinstance(value, typ):
        return value
    if typ is bool:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    return typ(value)


class Flags:
    """A typed flag store: one value per registered flag, read and written
    as attributes (``FLAGS.log_period``); unknown names raise
    ``AttributeError``.  ``Flags()`` holds the defaults."""

    def __init__(self, *, environ: bool = False) -> None:
        values = {}
        for spec in _SPECS.values():
            values[spec.name] = _initial(spec, environ)
        object.__setattr__(self, "_values", values)
        object.__setattr__(self, "_environ", environ)

    def __getattr__(self, name: str) -> Any:
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(f"unknown flag {name!r}") from None

    def __setattr__(self, name: str, value: Any) -> None:
        spec = _SPECS.get(name)
        if spec is None:
            raise AttributeError(f"unknown flag {name!r}")
        value = _coerce(value, spec.type)
        if spec.validator is not None and not spec.validator(value):
            raise ValueError(f"invalid value {value!r} for flag {name!r}")
        self._values[name] = value

    def as_dict(self) -> Dict[str, Any]:
        return dict(self._values)


def _initial(spec: _FlagSpec, environ: bool) -> Any:
    env = os.environ.get(_ENV_PREFIX + spec.name.upper()) if environ else None
    return _coerce(env, spec.type) if env is not None else spec.default


FLAGS = Flags(environ=True)


def _builtin_type(v: Any) -> type:
    for t in (bool, int, float, str):
        if isinstance(v, t):
            return t
    return object


def define_flag(name: str, default: Any, help: str = "", *,
                type: Optional[type] = None,
                validator: Optional[Callable[[Any], bool]] = None) -> None:
    """Register a flag; its value starts at ``default`` (or its
    ``PADDLE_TPU_TORCH_<NAME>`` environment override)."""
    spec = _FlagSpec(name, default, help, type or _builtin_type(default),
                     validator)
    with _LOCK:
        if name in _SPECS:
            raise ValueError(f"flag {name!r} already defined")
        _SPECS[name] = spec
        FLAGS._values[name] = _initial(spec, True)


def parse_flags(argv: Optional[List[str]] = None) -> List[str]:
    """Parse ``--name=value`` / ``--name value`` args into ``FLAGS``;
    returns the arguments that name no registered flag."""
    argv = list(sys.argv[1:] if argv is None else argv)
    rest = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg.startswith("--"):
            body = arg[2:]
            if "=" in body:
                name, value = body.split("=", 1)
            else:
                name = body
                if name in _SPECS and _SPECS[name].type is bool:
                    value = "true"
                elif i + 1 < len(argv):
                    value = argv[i + 1]
                    i += 1
                else:
                    value = "true"
            name = name.replace("-", "_")
            if name in _SPECS:
                setattr(FLAGS, name, value)
            else:
                rest.append(arg)
        else:
            rest.append(arg)
        i += 1
    return rest


def refuse_unparsed(rest: List[str], what: str = "") -> None:
    """The arguments ``parse_flags`` left: a flag of a part not ported yet
    raises naming its ROADMAP.md item; anything else is unrecognized."""
    from paddle_tpu_torch.utils.error import ConfigError, not_ported

    for arg in rest:
        name = (arg[2:].split("=", 1)[0].replace("-", "_")
                if arg.startswith("--") else None)
        if name in NOT_PORTED_FLAGS:
            raise not_ported(flag_part(name), NOT_PORTED_FLAGS[name])
    if rest:
        raise ConfigError(f"{what}unrecognized arguments: {rest}")


def flags_help() -> str:
    """One line per registered flag — the ``--help`` surface of the
    command line."""
    lines = []
    for name in sorted(_SPECS):
        spec = _SPECS[name]
        head = f"  --{name}={spec.default!r}"
        lines.append(f"{head:<40} {spec.help}" if spec.help else head)
    return "\n".join(lines)


# --- numerics and kernel paths ----------------------------------------------

define_flag("compute_dtype", "bfloat16", "matmul operand dtype (float32 or "
            "bfloat16); accumulation is always float32")
define_flag("decode_early_exit", True, "beam/greedy decode stops its token "
            "loop once every beam emitted EOS")
define_flag("beam_size", 3, "default beam width of the slot backend")
define_flag("fused_bigru", False, "a bidirectional GRU layer runs both "
            "directions in one time loop (K11) instead of two")

# --- mixed precision and rematerialisation ----------------------------------

define_flag("amp", False, "mixed-precision training: activations and "
            "matmul/conv outputs run in bf16 end-to-end (f32 master "
            "weights, f32 optimizer state); BN statistics, softmax/"
            "logsumexp reductions, and the loss stay f32 (the allowlist); "
            "dynamic loss scaling rides the bad-step guard: an overflow "
            "skips the step and halves the scale instead of aborting")
define_flag("loss_scale", 65536.0, "initial dynamic loss scale under "
            "--amp (grads are computed on scale*loss and unscaled before "
            "the update; 1 = start unscaled)",
            validator=lambda v: v >= 1.0)
define_flag("loss_scale_growth", 2000, "double the loss scale after N "
            "consecutive finite steps (0 = never grow: static scale)",
            validator=lambda v: v >= 0)
define_flag("loss_scale_max", 16777216.0, "dynamic loss scale ceiling "
            "(growth never doubles past this; halving floors at 1.0)",
            validator=lambda v: v >= 1.0)
define_flag("remat", False, "rematerialize the forward inside the "
            "backward (torch.utils.checkpoint around the loss): trades "
            "~1/3 more FLOPs for O(layer) activation memory, buying the "
            "larger batches the MFU-starved recurrent models need")

# --- the command line (paddle_trainer analog) -------------------------------

define_flag("job", "train", "CLI mode: train | test | checkgrad | time")
define_flag("config", "", "python config file defining get_config()")
define_flag("device", "cuda", "device the CLI's trainer and server run on: "
            "cuda (raises without a card) or cpu (the kernels' plain "
            "versions)")
define_flag("num_passes", 1, "training passes for the CLI train job")
define_flag("test_pass", -1, "checkpoint pass to test (-1 = latest)")
define_flag("time_batches", 10, "batches to time in --job=time")
define_flag("seed", 1, "global seed of the trainer's initial parameters")
define_flag("checkgrad_eps", 1e-3, "epsilon for finite-difference gradient "
            "checks")

# --- the trainer loop --------------------------------------------------------

define_flag("log_period", 100, "log every N batches")
define_flag("test_period", 0, "test every N batches (0 = per pass)")
define_flag("show_parameter_stats_period", 0, "print param stats every N "
            "batches")
define_flag("save_dir", "", "checkpoint root; pass dirs saved under it "
            "('' = no saving)")
define_flag("start_pass", 0, "resume training from this pass")
define_flag("saving_period", 1, "save checkpoint every N passes")
define_flag("prefetch_depth", 0, "double-buffered async host->device "
            "feeding: a background thread runs the DataFeeder AND the "
            "h2d transfer for batch N+1..N+depth while the device steps "
            "batch N, so `data_wait`/`prepare`/`h2d` collapse out of the "
            "step critical path (0 = off; 2 = classic double buffering; "
            "drains cleanly at checkpoint/preemption boundaries)",
            validator=lambda v: v >= 0)
define_flag("fused_apply", True, "the reference's fused multi-tensor "
            "optimizer apply; the port's per-leaf loop gives the same "
            "values either way")

# --- fault tolerance ---------------------------------------------------------

define_flag("resume", "", "'' = --start_pass behavior; 'auto' = resume from "
            "the newest VALID checkpoint under --save_dir",
            validator=lambda v: v in ("", "auto"))
define_flag("keep_last_n", 0, "checkpoint retention: keep only the newest N "
            "pass dirs under --save_dir (0 = keep all)")
define_flag("guard_nonfinite", True, "bad-step guard: hold the parameters, "
            "slots and step counter when the loss or the gradient norm is "
            "non-finite (decided on the device)")
define_flag("max_bad_steps", 8, "abort training after N CONSECUTIVE "
            "guard-skipped bad steps (0 = never abort)")
define_flag("checkpoint_on_preemption", True, "on SIGTERM/SIGINT, write an "
            "atomic checkpoint at the next batch boundary and exit cleanly "
            "(needs --save_dir; resume with --resume=auto)")
define_flag("reader_retries", 0, "CLI: wrap the config's reader in "
            "resilience.resilient_reader with this retry budget (0 = off)")


# --- the sharded data pipeline (datapipe/) -----------------------------------

define_flag("data_pack", False, "sequence packing: several short sequences "
            "share one padded row (segment ids and positions carried "
            "through the masks, the RNN carries and the sequence losses); "
            "the packed loss equals the unpacked one on the same samples")
define_flag("data_shards", 8, "shard count of `python -m paddle_tpu_torch "
            "data pack` (indexed record shards, a CRC per record, a footer "
            "index; the set is published atomically)",
            validator=lambda v: v >= 1)
define_flag("shuffle_seed", 0, "seed of the datapipe's global shuffle: each "
            "pass's record order is a permutation drawn from (seed, pass), "
            "so the iterator's cursor is O(1) and restorable")

# --- the serving runtime: `python -m paddle_tpu_torch serve` ----------------

define_flag("serve_bundle", "", "model bundle (.ptz) to serve with "
            "`python -m paddle_tpu_torch serve`")
define_flag("serve_max_batch", 8, "serving: max rows coalesced into one "
            "batch (batch buckets are powers of two up to this)")
define_flag("serve_batch_delay_ms", 2.0, "serving: micro-batching window — "
            "how long the worker waits to coalesce more same-shape requests")
define_flag("serve_queue_depth", 64, "serving: bounded queue depth; a full "
            "queue sheds new requests immediately (typed ShedError)")
define_flag("serve_deadline_ms", 1000.0, "serving: default per-request "
            "deadline; infeasible deadlines are rejected at admission "
            "(0 = no deadline)")
define_flag("serve_breaker_threshold", 5, "serving: consecutive batch "
            "failures that trip the circuit breaker OPEN")
define_flag("serve_breaker_cooldown_s", 5.0, "serving: seconds the breaker "
            "stays OPEN before letting a half-open probe through")
define_flag("serve_max_restarts", 3, "serving: worker restart budget before "
            "the server reports failed and drains with typed errors")
define_flag("serve_backoff_s", 0.5, "serving: base worker-restart backoff "
            "(exponential, doubled per restart)")
define_flag("serve_hang_timeout_s", 0.0, "serving: a batch in flight longer "
            "than this marks the worker hung and replaces it (0 = off)")
define_flag("serve_smoke", 0, "serving CLI: push N synthetic requests "
            "through the server, print healthz, and exit (CI self-test; "
            "0 = serve until SIGTERM)")
define_flag("serve_nonfinite", "error", "serving: 'error' fails requests "
            "whose outputs contain NaN/Inf (counts toward the breaker); "
            "'allow' passes them through",
            validator=lambda v: v in ("error", "allow"))
define_flag("serve_continuous", False, "serving: continuous slot-based "
            "batching for generation backends — finished requests' decode "
            "slots are recycled to queued requests between steps; bucket "
            "mode stays the default for one-shot forwards")
define_flag("serve_slots", 8, "serving: decode slot capacity of the "
            "continuous-batching table (each slot holds one request's "
            "beams; also the admission row bound in generation mode)",
            validator=lambda v: v >= 1)
define_flag("spec_decode", False, "serving: speculative decoding over the "
            "slot table — a host draft proposer offers --spec_k candidate "
            "tokens per slot and one wide-verify step accepts the longest "
            "prefix the model itself would emit; greedy (beam_size=1) "
            "backends only, outputs stay bit-identical to one-token "
            "stepping")
define_flag("spec_k", 4, "serving: draft tokens per slot per speculative "
            "step (the wide verify scores k+1 positions; tune against "
            "healthz spec_accept_rate)", validator=lambda v: v >= 1)
define_flag("prefix_cache_mb", 0.0, "serving: host MiB budget for the "
            "prefix/session cache — requests repeating a source (or chat "
            "session) reuse the cached encoder state as slot prefill, "
            "keyed by content hash with LRU eviction (0 = off)",
            validator=lambda v: v >= 0.0)
define_flag("slot_page_pool", 0.0, "serving: host MiB budget for paged "
            "slot state — with the table full and work queued, cold slot "
            "carries are host-evicted and later restored bit-for-bit "
            "(0 = off)", validator=lambda v: v >= 0.0)

# --- deploy bundles -----------------------------------------------------------

define_flag("deploy_quantize", "", "bundle export weight quantization: "
            "'' keeps f32; 'bf16' halves the weight payload; 'int8' "
            "stores matmul-sized tensors as symmetric per-channel int8 "
            "(~4x smaller) with scales alongside — every quantized "
            "export is gated by a max-abs-error check against the f32 "
            "forward (merge_model quantize_tol)",
            validator=lambda v: v in ("", "bf16", "int8"))

# --- continuous delivery: publish, reload, fleet, compile cache ------------

define_flag("publish_dir", "", "versioned publish directory for gated "
            "deploy bundles (v-%05d dirs + shared compile cache); '' "
            "disables publication")
define_flag("publish_every", 0, "publish a deploy bundle every N passes "
            "(from the newest VERIFIED checkpoint under --save_dir; 0 = "
            "never)", validator=lambda v: v >= 0)
define_flag("reload_probation", 32, "hot-reload probation window in "
            "completed requests before a swapped-in version is committed "
            "and its predecessor released", validator=lambda v: v >= 1)
define_flag("serve_watch", False, "serving CLI: serve from the newest "
            "valid version under --publish_dir and hot-reload newer "
            "publishes as they land (zero-downtime swap + probation "
            "rollback); with --serve_smoke=N runs the publish->reload "
            "self-test instead")
define_flag("serve_fleet", False, "serving CLI: multi-model fleet mode — "
            "a model table keyed (name, version) with the whole "
            "breaker/ladder/warmup stack instantiated per entry, tenant "
            "quotas + weighted fair share in front, canary/shadow rollout "
            "with per-entry auto-rollback; with --serve_smoke=N runs the "
            "two-model two-tenant isolation self-test")
define_flag("serve_canary_pct", 0.0, "fleet: percentage of a model's "
            "traffic routed to its canary candidate over the "
            "deterministic hash-of-request split (same request key -> "
            "same arm across retries)",
            validator=lambda v: 0.0 <= v <= 100.0)
define_flag("serve_probation_requests", 32, "fleet: resolved requests a "
            "canary must serve cleanly before it is promoted to "
            "incumbent; a breaker trip or error-rate regression inside "
            "the window auto-rolls it back (journaled publish_rollback "
            "naming the entry)", validator=lambda v: v >= 1)
define_flag("serve_shadow", False, "fleet: mirror traffic to the rollout "
            "candidate while every reply still comes from the incumbent; "
            "output divergence is counted and journaled "
            "(shadow_divergence), never served")
define_flag("tenant_spec", "", "fleet tenancy: comma-separated "
            "'name:weight:rate:burst' tenant contracts, e.g. "
            "'gold:3:100:20,free:1:10:5' — weight shares the fleet under "
            "contention, rate/burst bound the tenant's own token bucket "
            "(empty = untenanted); a zero weight is refused typed at "
            "construction")
define_flag("tenant_capacity_rate", 0.0, "fleet tenancy: aggregate "
            "requests/s the fleet admits before weighted fair-share "
            "shedding kicks in (0 = the sum of tenant rates)",
            validator=lambda v: v >= 0.0)
define_flag("tenant_credit", 1.0, "fleet tenancy: fair-queuing slack in "
            "weighted request units a tenant may run ahead of the global "
            "virtual clock before it is shed "
            "(QuotaExceeded(fair_share=True))",
            validator=lambda v: v > 0.0)
define_flag("compile_cache_dir", "auto", "persistent cache of the built "
            "kernel libraries shared across serving replicas "
            "(config/compile_cache.py): a library built on the first boot "
            "is stored here and LOADED (no nvcc) on every later boot, "
            "after a smoke call against its plain version; bundles can "
            "also carry entries as aot/ members (config.warm_bundle).  "
            "'auto' (the default) lets the serve CLI derive a per-bundle "
            "cache next to the artifact (<bundle>.ccache); an explicit "
            "empty value (--compile_cache_dir=) opts out")

# --- resilience and telemetry -------------------------------------------------

define_flag("scrub_every_s", 0.0, "background checkpoint scrubber cadence: "
            "re-hash the manifested CRCs of the checkpoint chain and the "
            "deploy bundles under --save_dir every N seconds; a newly "
            "corrupt pass dir is QUARANTINED out of latest_pass "
            "eligibility, journaled as a scrub_fail anchor, and scrub.json "
            "records the newest fully verified pass (0 = off)",
            validator=lambda v: v >= 0.0)
define_flag("obs_journal", "", "directory for the rank-tagged structured "
            "event journal (append-only events-r*.jsonl; '' = off)")

# --- parallelism and the pserver tier (parallel/, pserver/) -------------------

define_flag("mesh_shape", "", "the mesh of the launched world, e.g. '2' or "
            "'2x2' (empty = one data axis over every rank); its size must "
            "equal the world size the launcher started")
define_flag("mesh_axes", "data", "comma-separated mesh axis names, e.g. "
            "'data,model'")
define_flag("pserver_axis", "model", "mesh axis embedding tables marked "
            "sparse_grad shard their vocab over; a trainer mesh carrying "
            "this axis routes them through the pserver tier (all-to-all "
            "lookup + row-sparse updates that never densify)")
define_flag("pserver_pad_vocab", True, "pad table vocabs up to a shard "
            "multiple with masked tail rows; off = a non-dividing vocab "
            "raises a typed ConfigError naming the table")

#: the reference's flags of parts the port does not have yet, and the
#: ROADMAP.md Queue 1 item that ports each; the command line refuses them
NOT_PORTED_FLAGS: Dict[str, int] = {
    **dict.fromkeys(("num_virtual_devices", "dcn_axis", "dcn_compress",
                     "dcn_timeout_s", "dcn_retries"), 8),
    **dict.fromkeys(("sdc_check_every", "obs_timeline",
                     "obs_peak_flops", "metrics_port",
                     "trace_sample", "trace_tail_p99", "profile_dir",
                     "profile_steps", "enable_timers", "check_nan",
                     "gang_max_restarts", "gang_heartbeat_s",
                     "gang_watchdog_s", "gang_elastic", "gang_min_ranks",
                     "gang_grow_back", "gang_resize_timeout_s",
                     "gang_backoff_jitter", "deploy_lint",
                     "serve_preflight"), 9),
}

#: the part of its ROADMAP.md item a refused flag waits for
_FLAG_PARTS: Dict[str, str] = {
    **dict.fromkeys(("dcn_axis", "dcn_compress", "dcn_timeout_s",
                     "dcn_retries"), "the dcn hierarchy, parallel/"
                    "hierarchical.py"),
    "num_virtual_devices": "force_virtual_devices",
}


def flag_part(name: str) -> str:
    """``--name``, with the part of its item that ports it where known."""
    part = _FLAG_PARTS.get(name)
    return f"--{name} ({part})" if part else f"--{name}"
