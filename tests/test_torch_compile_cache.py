"""The port's compile cache (``paddle_tpu_torch/config/compile_cache.py``)
on the CPU, with the ``g++``-built native data core (``data/native.py``)
as the cached artifact: the CUDA kernel libraries take the same path on
the card (``tests/test_torch_cuda.py``: a warm boot with zero ``nvcc``
runs).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_compile_cache.py -q

The contracts of ``tests/test_compile_cache.py`` on the port's artifact:

- the storage layer: a round trip and its counters; stale (another
  platform), mis-keyed, bit-flipped and truncated entries are LOGGED
  misses, never a crash and never a wrong library; a pristine rewrite
  loads again;
- a warm boot: a fresh build dir loads the library from the cache with
  ZERO compiler runs, after its smoke call passed, and every entry point
  agrees with the library the cold boot built; a corrupt entry or a failed
  smoke call is a logged miss, a rebuild and a repaired entry;
- bundle-embedded ``aot/`` members (``warm_bundle``, ``open_cache``), a
  damaged member falling back to a build, ``warm_bundle`` repairing it;
- ``InferenceModel.prime`` returns each of its four values, and
  ``SlotScheduler.prime`` is idempotent across caches (a fresh cache gets
  the resident library stored);
- ``load_inference_model(arch_fingerprint=True)`` equals the JAX package's
  architecture fingerprint for the same bundle file (f32 and int8, merged
  by either package).

The reference's ``test_compile_cache`` fails in this repository's tier-1
runs (ROADMAP.md Queue 3: its shared compile cache), so the port is held to
its contracts, not its pass/fail.  Each test points the
native core at its own build dir and restores the module afterwards.
"""

import json
import logging
import os

import numpy as np
import pytest

import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.config import compile_cache as cc
from paddle_tpu_torch.config import deploy
from paddle_tpu_torch.config.compile_cache import (BundleAotCache,
                                                   ChainCache,
                                                   CompileCacheDir,
                                                   cache_key, open_cache,
                                                   platform_fingerprint,
                                                   serialization_supported,
                                                   warm_bundle)
from paddle_tpu_torch.data import native
from paddle_tpu_torch.ops import compute_dtype_scope
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.utils.log import logger

PLAT = platform_fingerprint("g++")


@pytest.fixture(autouse=True)
def f32():
    with compute_dtype_scope("float32"):
        yield


@pytest.fixture
def warnings_log():
    """The port logger's warnings (it does not propagate to the root)."""
    records = []

    class _H(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    h = _H(level=logging.WARNING)
    logger.addHandler(h)
    yield records
    logger.removeHandler(h)


@pytest.fixture
def fresh_native(monkeypatch):
    """``boot(build_dir)``: forget the loaded native core and point its
    build dir elsewhere, as a fresh process with that ``_build`` would."""
    saved = (native._lib, native._tried, native._error)
    counters = dict(vars(native.NATIVE))

    def boot(build_dir):
        native._lib, native._tried, native._error = None, False, None
        monkeypatch.setattr(native, "BUILD_DIR", str(build_dir))

    yield boot
    native._lib, native._tried, native._error = saved
    vars(native.NATIVE).update(counters)


def _native_outputs():
    seqs = [[1, 2, 3], [4], [5, 6, 7, 8, 9, 10], [11, 12]]
    return (native.pad_batch_i32(seqs, 5),
            native.pack_sequences(seqs, 2, 8),
            native.count_tokens(seqs, 16),
            native.shuffle_indices(9, 3))


def _same(a, b):
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the storage layer
# ---------------------------------------------------------------------------


def test_cache_dir_roundtrip_and_counters(tmp_path):
    """tests/test_compile_cache.py::test_cache_dir_roundtrip_and_counters."""
    assert serialization_supported()
    cache = CompileCacheDir(str(tmp_path / "cache"))
    key = cache_key("unit", "fp", "sig")
    assert cache.load(key, PLAT) is None and cache.misses == 1
    assert cache.store(key, b"\x7fELF payload", platform=PLAT, label="unit")
    payload, header = cache.load(key, PLAT)
    assert payload == b"\x7fELF payload" and cache.hits == 1
    assert header["label"] == "unit" and header["platform"] == PLAT
    assert cache.load(cache_key("unit", "fp", "other"), PLAT) is None
    assert cache.peek(key, PLAT) and not cache.peek(key, "other")
    assert (cache.hits, cache.misses) == (1, 2)   # peek counts nothing


def test_cache_entry_staleness_and_corruption(tmp_path, warnings_log):
    """tests/test_compile_cache.py::test_cache_entry_staleness_and_corruption:
    stale, mis-keyed and damaged entries are logged misses."""
    cache = CompileCacheDir(str(tmp_path / "cache"))
    key = cache_key("unit", "stale")
    cache.store(key, os.urandom(4096), platform=PLAT)
    path = cache._path(key)
    blob = open(path, "rb").read()
    head_raw, body = blob.split(b"\n", 1)
    head = json.loads(head_raw)

    stale = dict(head, platform="cpu:riscv64:g++ 1.0:-O0")
    open(path, "wb").write(json.dumps(stale).encode() + b"\n" + body)
    assert cache.load(key, PLAT) is None
    assert "stale" in warnings_log[-1]

    open(path, "wb").write(blob)
    other = cache_key("unit", "other-library")
    import shutil

    shutil.copy(path, cache._path(other))
    assert cache.load(other, PLAT) is None
    assert "key mismatch" in warnings_log[-1]

    assert chaos.corrupt_compile_cache(cache.root, key=key) == path
    assert cache.load(key, PLAT) is None
    assert "CRC mismatch" in warnings_log[-1]
    open(path, "wb").write(blob)
    chaos.corrupt_compile_cache(cache.root, key=key, mode="truncate")
    assert cache.load(key, PLAT) is None
    open(path, "wb").write(b"not json\n" + body)
    assert cache.load(key, PLAT) is None
    assert "unparsable header" in warnings_log[-1]

    open(path, "wb").write(blob)      # the validation is the only gate
    assert cache.load(key, PLAT)[0] == body
    assert (cache.hits, cache.misses) == (1, 5)


# ---------------------------------------------------------------------------
# the native core through the cache
# ---------------------------------------------------------------------------


def test_warm_boot_loads_the_library_with_zero_compiler_runs(
        tmp_path, fresh_native):
    """A cold boot builds the library (one ``g++`` run) and stores it; a
    fresh build dir then loads it from the cache with no ``g++`` run,
    after a smoke call of every entry point, and every entry point agrees
    with the cold boot's library."""
    cache = CompileCacheDir(str(tmp_path / "cache"))
    fresh_native(tmp_path / "build-a")
    builds = native.NATIVE.builds
    with cc.priming(cache) as counts:
        cold = _native_outputs()
    assert counts == {"hits": 0, "misses": 1,
                      "libraries": {"dataio": "miss"}}
    assert native.NATIVE.builds == builds + 1
    assert native.NATIVE.origin == "built" and native.native_available()
    assert len(os.listdir(cache.root)) == 1

    fresh_native(tmp_path / "build-b")
    with cc.priming(cache) as counts:
        warm = _native_outputs()
    assert counts == {"hits": 1, "misses": 0,
                      "libraries": {"dataio": "hit"}}
    assert native.NATIVE.builds == builds + 1      # zero g++ runs
    assert native.NATIVE.origin == "cache"
    assert set(native.NATIVE.smoke_result) == {
        "shuffle_indices", "bucket_by_length", "argsort_by_length",
        "pad_batch_i32", "pack_sequences", "count_tokens"}
    assert os.listdir(tmp_path / "build-b") == [
        os.path.basename(native.library_path())]  # renamed into place
    assert _same(cold, warm)
    stats = cc.library_stats()["dataio"]
    assert stats["origin"] == "cache" and stats["cache_loads"] >= 1
    # a second priming in the same process: resident, found in the cache
    with cc.priming(cache) as counts:
        _native_outputs()
    assert counts["hits"] == 1 and counts["misses"] == 0


@pytest.mark.parametrize("damage", ["corrupt", "truncate", "stale"])
def test_damaged_entry_is_a_logged_miss_that_rebuilds_and_repairs(
        tmp_path, fresh_native, warnings_log, damage):
    """tests/test_compile_cache.py::
    test_corrupt_cache_entry_falls_back_to_compile and
    test_stale_entries_ignored_across_fingerprints: a damaged or stale
    entry is logged, the library is rebuilt (one ``g++`` run), answers as
    before, and the entry is repaired for the next boot."""
    cache = CompileCacheDir(str(tmp_path / "cache"))
    fresh_native(tmp_path / "b0")
    with cc.priming(cache):
        ref = _native_outputs()
    victim = os.path.join(cache.root, os.listdir(cache.root)[0])
    if damage == "stale":
        head_raw, body = open(victim, "rb").read().split(b"\n", 1)
        head = dict(json.loads(head_raw), platform="cpu:x:g++ 0.1:-O0")
        open(victim, "wb").write(json.dumps(head).encode() + b"\n" + body)
    else:
        chaos.corrupt_compile_cache(cache.root, mode=damage)
    fresh_native(tmp_path / "b1")
    builds = native.NATIVE.builds
    with cc.priming(cache) as counts:
        got = _native_outputs()
    assert counts["misses"] == 1 and native.NATIVE.builds == builds + 1
    assert native.NATIVE.origin == "built"
    assert any("rebuilding" in w for w in warnings_log)
    assert _same(ref, got)
    fresh_native(tmp_path / "b2")                 # repaired
    with cc.priming(cache) as counts:
        _native_outputs()
    assert counts["hits"] == 1 and native.NATIVE.builds == builds + 1


def test_failed_smoke_call_rebuilds_and_repairs(tmp_path, fresh_native,
                                                warnings_log, monkeypatch):
    """A library loaded from the cache that fails its smoke call is never
    trusted: logged, rebuilt and the entry restored."""
    cache = CompileCacheDir(str(tmp_path / "cache"))
    fresh_native(tmp_path / "b0")
    with cc.priming(cache):
        ref = _native_outputs()
    calls = []

    def bad_smoke():
        calls.append(1)
        raise RuntimeError("entry point disagrees")

    monkeypatch.setattr(native, "_smoke", bad_smoke)
    fresh_native(tmp_path / "b1")
    builds = native.NATIVE.builds
    with cc.priming(cache) as counts:
        got = _native_outputs()
    assert calls == [1] and counts["misses"] == 1
    assert native.NATIVE.builds == builds + 1
    assert any("smoke call" in w for w in warnings_log)
    assert _same(ref, got)
    assert not [n for n in os.listdir(tmp_path / "b1") if "cache" in n]


def test_active_cache_without_priming_loads_and_stores(tmp_path,
                                                       fresh_native):
    """``using_cache`` alone (the serve command line's process-wide cache):
    a build stores, a fresh boot loads."""
    cache = CompileCacheDir(str(tmp_path / "cache"))
    fresh_native(tmp_path / "b0")
    with cc.using_cache(cache):
        assert native.native_available()
    assert cache.peek(native.NATIVE.cache_key(), PLAT)
    fresh_native(tmp_path / "b1")
    builds = native.NATIVE.builds
    with cc.using_cache(cache):
        assert native.native_available()
    assert native.NATIVE.builds == builds and native.NATIVE.origin == "cache"
    assert cc.active_cache() is None


# ---------------------------------------------------------------------------
# bundles and prime
# ---------------------------------------------------------------------------


def _bundle(tmp_path, rng, nn=tnn, merge=None, quantize=None, name="cc",
            file=None):
    """tests/test_compile_cache.py's bundle: fc 64 -> 128 -> 16, one Adam
    step, merged by the port (or by ``merge``, the JAX package's)."""
    nn.reset_naming()
    x = nn.data("x", size=64)
    h = nn.fc(x, 128, act="tanh", name="h")
    out = nn.fc(h, 16, act="softmax", name="out")
    label = nn.data("label", size=1, dtype="int32")
    cost = nn.classification_cost(out, label, name="cost")
    path = str(tmp_path / f"{file or name}.ptz")
    if merge is None:
        from paddle_tpu_torch.param import Adam
        from paddle_tpu_torch.trainer import SGDTrainer

        tr = SGDTrainer(cost, Adam(learning_rate=0.01), seed=0,
                        device="cpu")
        tr.train_batch({"x": rng.randn(8, 64).astype(np.float32),
                        "label": rng.randint(0, 16, (8, 1)).astype(
                            np.int32)})
        deploy.merge_model(path, tr.topology, tr.params, tr.state,
                           name=name, quantize=quantize)
    else:
        merge(path, cost, rng, name, quantize)
    return path


@pytest.fixture
def native_on_path(monkeypatch):
    """Every InferenceModel forward also runs the native core (a kernel
    library on the path): on the CPU the plain versions run no library."""
    orig = deploy.InferenceModel._make_run

    def make_run(self, names):
        run = orig(self, names)

        def with_native(params, state, feed):
            native.pad_batch_i32([[1, 2, 3]], 4)
            return run(params, state, feed)

        return with_native

    monkeypatch.setattr(deploy.InferenceModel, "_make_run", make_run)


def test_prime_returns_its_four_values(tmp_path, rng, fresh_native,
                                       native_on_path):
    """``"compiled"`` without a cache, ``"miss"`` when the library is built
    and stored, ``"warm"`` for a primed signature, ``"hit"`` when the cache
    served (or already held) every library; ``compile_events`` counts the
    calls the cache did not serve.  Without a library on the path (the
    plain CPU forward) a cache can give nothing: ``"compiled"``."""
    bundle = _bundle(tmp_path, rng)
    cache = CompileCacheDir(str(tmp_path / "cache"))
    fresh_native(tmp_path / "b0")
    m = deploy.load_inference_model(bundle, device="cpu")
    f1 = {"x": np.zeros((1, 64), np.float32)}
    f2 = {"x": np.zeros((2, 64), np.float32)}
    f4 = {"x": np.zeros((4, 64), np.float32)}
    assert m.prime(f1, outputs=["out"]) == "compiled"
    assert m.prime(f1, outputs=["out"], cache=cache) == "warm"
    assert m.prime(f2, outputs=["out"], cache=cache) == "miss"
    assert m.prime(f4, outputs=["out"], cache=cache) == "hit"
    assert m.compile_events == 2
    fresh_native(tmp_path / "b1")
    m2 = deploy.load_inference_model(bundle, device="cpu")
    assert m2.prime(f1, outputs=["out"], cache=cache) == "hit"
    assert native.NATIVE.origin == "cache" and m2.compile_events == 0


def test_warm_bundle_embeds_and_serves(tmp_path, rng, fresh_native,
                                       native_on_path):
    """tests/test_compile_cache.py::test_warm_bundle_embeds_and_serves:
    ``warm_bundle`` embeds the library as an ``aot/`` member; a replica
    serving the artifact through ``open_cache`` (read-only) boots with
    no compiler run; a damaged member falls back to a build with the same
    replies; re-running ``warm_bundle`` repairs it."""
    from paddle_tpu_torch.serving import InferenceServer

    bundle = _bundle(tmp_path, rng, quantize="int8")
    warm = [{"x": np.zeros((1, 64), np.float32)}]
    fresh_native(tmp_path / "b0")
    counts = warm_bundle(bundle, outputs=["out"], feeds=warm, device="cpu")
    assert counts == {"hits": 3, "misses": 1, "buckets": 4}
    assert BundleAotCache(bundle).has_entries()
    deploy.load_inference_model(bundle, device="cpu")   # still a bundle

    feed = {"x": rng.randn(2, 64).astype(np.float32)}

    def boot(build_dir):
        fresh_native(build_dir)
        model = deploy.load_inference_model(bundle, device="cpu")
        srv = InferenceServer(model, max_batch=8, outputs=["out"],
                              default_deadline_ms=60000)
        cache = open_cache(bundle=bundle)
        assert isinstance(cache, BundleAotCache) and not cache.writable
        srv.start(warmup_feed=warm, compile_cache=cache)
        try:
            return (srv.healthz()["cold_start"], model,
                    srv.infer(feed, deadline_ms=60000)["out"])
        finally:
            srv.close()

    builds = native.NATIVE.builds
    hz, model, ref = boot(tmp_path / "b1")
    assert native.NATIVE.builds == builds
    assert model.compile_events == 0 and hz["compile_cache_misses"] == 0
    assert hz["compile_cache_hits"] == 4

    victim = chaos.corrupt_compile_cache(bundle)
    assert victim is not None and victim.startswith("aot/")
    hz, model, got = boot(tmp_path / "b2")
    assert native.NATIVE.builds == builds + 1        # rebuilt
    assert model.compile_events >= 1 and hz["compile_cache_misses"] >= 1
    assert np.array_equal(got, ref)
    deploy.load_inference_model(bundle, device="cpu")

    counts2 = warm_bundle(bundle, outputs=["out"], feeds=warm, device="cpu")
    assert counts2["misses"] == 1 and counts2["hits"] == 3
    hz, model, _ = boot(tmp_path / "b3")
    assert model.compile_events == 0 and native.NATIVE.builds == builds + 1


def test_open_cache_policy(tmp_path, rng):
    bundle = _bundle(tmp_path, rng)
    assert open_cache() is None and open_cache(bundle=bundle) is None
    assert isinstance(open_cache(cache_dir=str(tmp_path / "c")),
                      CompileCacheDir)
    BundleAotCache(bundle, writable=True).store(
        cache_key("x"), b"lib", platform=PLAT)
    chain = open_cache(bundle=bundle, cache_dir=str(tmp_path / "c"))
    assert isinstance(chain, ChainCache) and len(chain.caches) == 2
    assert chain.load(cache_key("x"), PLAT)[0] == b"lib"
    assert chain.store(cache_key("y"), b"two", platform=PLAT)  # the dir
    assert CompileCacheDir(str(tmp_path / "c")).peek(cache_key("y"), PLAT)


def test_slot_prime_is_idempotent_across_caches(tmp_path, fresh_native,
                                                monkeypatch):
    """tests/test_compile_cache.py::
    test_slot_prime_is_idempotent_across_caches, with the native core on
    the table's prefill: a first prime stores it (a miss), a second against
    the same cache hits, a third against a FRESH cache stores it again;
    without a cache prime is skipped."""
    from paddle_tpu_torch.serving.slots import (SlotScheduler,
                                                example_slot_backend)

    backend = example_slot_backend(beam_size=2, src_len=8, max_len=8,
                                   vocab=64, dim=16, device="cpu")
    orig = backend.prefill

    def prefill(*a, **kw):
        native.pad_batch_i32([[1, 2]], 3)
        return orig(*a, **kw)

    monkeypatch.setattr(backend, "prefill", prefill)
    sched = SlotScheduler(backend, slots=2)
    feeds = [backend.example_feed(1)]
    fresh_native(tmp_path / "b0")
    assert sched.prime(None, feeds)["skipped"]
    c1 = sched.prime(CompileCacheDir(str(tmp_path / "a")), feeds)
    assert (c1["misses"], c1["hits"], c1["skipped"]) == (1, 0, False)
    c2 = sched.prime(CompileCacheDir(str(tmp_path / "a")), feeds)
    assert (c2["misses"], c2["hits"]) == (0, 1)
    c3 = sched.prime(CompileCacheDir(str(tmp_path / "b")), feeds)
    assert c3["misses"] == c1["misses"]
    assert (sched.cache_hits, sched.cache_misses) == (1, 2)
    assert sched.occupied() == 0 and sched.admitted > 0  # reset after


# ---------------------------------------------------------------------------
# the architecture fingerprint against the JAX package
# ---------------------------------------------------------------------------


def _jax_merge(path, cost, rng, name, quantize):
    from paddle_tpu.config import merge_model
    from paddle_tpu.param.optimizers import Adam
    from paddle_tpu.trainer import SGDTrainer

    tr = SGDTrainer(cost, Adam(learning_rate=0.01), seed=0)
    tr.train_batch({"x": rng.randn(8, 64).astype(np.float32),
                    "label": rng.randint(0, 16, (8, 1)).astype(np.int32)})
    merge_model(path, tr.topology, tr.params, tr.state, name=name,
                quantize=quantize)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_arch_fingerprint_equals_the_reference(tmp_path, rng, quantize):
    """For the same bundle file both packages' ``arch_fingerprint=True``
    give the same identity, for a bundle either package merged; two weight
    versions of one model share it, and the payload fingerprint (the
    default) differs between them in both packages.  (The identity covers
    the config proto, whose model name and framework version the merging
    package writes: the JAX package's bundle has its own.)"""
    import paddle_tpu.nn as jnn
    from paddle_tpu.config import load_inference_model as jload

    paths = [_bundle(tmp_path, rng, quantize=quantize, file="p1"),
             _bundle(tmp_path, rng, quantize=quantize, file="p2"),
             _bundle(tmp_path, rng, nn=jnn, merge=_jax_merge,
                     quantize=quantize, file="j1")]
    fps = []
    for p in paths:
        port = deploy.load_inference_model(p, device="cpu",
                                           arch_fingerprint=True)
        ref = jload(p, arch_fingerprint=True)
        assert port.fingerprint == ref.fingerprint
        fps.append(port.fingerprint)
        assert deploy.load_inference_model(p, device="cpu").fingerprint \
            == jload(p).fingerprint
    assert fps[0] == fps[1] != fps[2]
    assert deploy.load_inference_model(paths[0], device="cpu").fingerprint \
        != deploy.load_inference_model(paths[1], device="cpu").fingerprint
