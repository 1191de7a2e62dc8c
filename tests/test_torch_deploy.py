"""The port's deploy bundles (``paddle_tpu_torch/config/deploy.py``) and
bucket-mode serving of them, against the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_deploy.py -q

- Cross bundles: a bundle the JAX package merges loads in the port, and one
  the port merges loads in the JAX package, in f32, bf16 and int8; both
  ``InferenceModel.infer`` agree within rtol 1e-5 / atol 1e-6 (the
  reference's f32 RNN tolerance).  The bf16 and int8 ``params.npz`` hold the
  same arrays bit for bit in both packages (names, dtypes, shapes, bytes;
  the zip members' timestamps differ), and the port's bfloat16 rounding
  equals ``ml_dtypes``' on every class of float32 (ties, NaN payloads,
  infinities, subnormals).
- The behaviours of ``tests/test_deploy_quant.py`` and
  ``tests/test_deploy_aot.py`` on the port: the gate rejects at a tight
  tolerance, scale members are validated, corruption raises typed errors
  naming the member, empty rows and a missing slot, concurrent ``infer``
  with mixed shapes; ``prime`` and the fingerprint; the refusals.
- ``InferenceServer`` over an ``InferenceModel`` in bucket mode: every reply
  equals ``infer`` of the request alone (unpadded) bit for bit, warmup
  primes each bucket once, a zero-row request replies empty inline.

Compute is float32 (``compute_dtype_scope``); the nets are narrow.
"""

import io
import json
import signal
import threading
import zipfile

import ml_dtypes
import numpy as np
import pytest

import paddle_tpu.nn as jnn
from paddle_tpu.config import load_inference_model as jload
from paddle_tpu.config import merge_model as jmerge
from paddle_tpu.config.deploy import quantize_params as jquantize
from paddle_tpu.param.optimizers import Adam as JAdam
from paddle_tpu.trainer import SGDTrainer as JTrainer

import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.config import (BundleCorruptError, InferenceModel,
                                     load_inference_model, merge_model,
                                     quantize_params)
from paddle_tpu_torch.config.deploy import _bf16_bits, feed_signature
from paddle_tpu_torch.nn import params_from_jax
from paddle_tpu_torch.ops import compute_dtype_scope
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.serving import InferenceServer
from paddle_tpu_torch.serving.errors import InvalidRequestError
from paddle_tpu_torch.utils.error import ConfigError

D, H, C, T = 16, 16, 4, 6
HARD_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _f32_and_alarm():
    def _abort(signum, frame):
        raise RuntimeError(f"deploy test exceeded {HARD_TIMEOUT_S}s")

    prev = signal.signal(signal.SIGALRM, _abort)
    signal.alarm(HARD_TIMEOUT_S)
    with compute_dtype_scope("float32"):
        yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


def _net(nn, device=None):
    """The reference's LSTM gate model (``tests/test_deploy_quant.py::
    _recurrent_net``) at width 16, for either package.  Returns (cost,
    serving topology over ``out``)."""
    nn.reset_naming()
    x = nn.data("x", size=D, is_seq=True)
    l = nn.lstmemory(x, H, name="lstm")
    pool = nn.pooling(l, pooling_type="max", name="pool")
    out = nn.fc(pool, C, act="softmax", name="out")
    label = nn.data("label", size=1, dtype="int32")
    cost = nn.classification_cost(out, label, name="cost")
    topo = (nn.Topology(out) if device is None
            else nn.Topology(out, device=device))
    return cost, topo


def _seq_feed(rng, rows, t=T, lengths=None):
    lens = (np.asarray(lengths, np.int32) if lengths is not None else
            rng.randint(1, t + 1, rows).astype(np.int32))
    return {"x": (rng.randn(rows, t, D).astype(np.float32), lens)}


@pytest.fixture(scope="module")
def trained():
    """The JAX net trained two Adam steps on random labels (a collapsed
    softmax would make the quantization gate vacuous), with its params as
    numpy."""
    rng = np.random.RandomState(0)
    cost, _ = _net(jnn)
    tr = JTrainer(cost, JAdam(learning_rate=0.01), seed=0)
    batch = {**_seq_feed(rng, 4), "label": rng.randint(0, C, (4, 1))
             .astype(np.int32)}
    for _ in range(2):
        tr.train_batch(batch)
    return {k: np.asarray(v) for k, v in tr.params.items()}


def _jax_bundle(path, params, quantize):
    _, topo = _net(jnn)
    return jmerge(str(path), topo, params, {}, name="m", quantize=quantize)


def _port_bundle(path, params, quantize):
    _, topo = _net(tnn, "cpu")
    return merge_model(str(path), topo, params_from_jax(params, "cpu"), {},
                       name="m", quantize=quantize)


def _npz(path):
    with zipfile.ZipFile(path) as z:
        return dict(np.load(io.BytesIO(z.read("params.npz")),
                            allow_pickle=False))


# ---------------------------------------------------------------------------
# bundles across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantize", [None, "bf16", "int8"])
def test_jax_bundle_loads_in_the_port(tmp_path, trained, quantize):
    path = _jax_bundle(tmp_path / "j.ptz", trained, quantize)
    feed = _seq_feed(np.random.RandomState(1), 3)
    want = jload(path).infer(feed, outputs=["out"])["out"]
    m = load_inference_model(path, device="cpu")
    assert m.bundle_path == path and m.output_names == ["out"]
    got = m.infer(feed)["out"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("quantize", [None, "bf16", "int8"])
def test_port_bundle_loads_in_the_jax_package(tmp_path, trained, quantize):
    path = _port_bundle(tmp_path / "t.ptz", trained, quantize)
    feed = _seq_feed(np.random.RandomState(2), 3)
    want = load_inference_model(path, device="cpu").infer(feed)["out"]
    got = jload(path).infer(feed, outputs=["out"])["out"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    q = json.loads(zipfile.ZipFile(path).read("manifest.json")).get(
        "quantize")
    if quantize:
        assert q["mode"] == quantize and 0.0 < q["max_abs_err"] <= q["tol"]


@pytest.mark.parametrize("quantize", ["bf16", "int8"])
def test_quantized_payloads_equal_between_the_packages(tmp_path, trained,
                                                       quantize):
    a = _npz(_jax_bundle(tmp_path / "j.ptz", trained, quantize))
    b = _npz(_port_bundle(tmp_path / "t.ptz", trained, quantize))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k
    assert any(v.dtype == (np.int8 if quantize == "int8" else np.uint16)
               for v in b.values())
    mj = json.loads(zipfile.ZipFile(tmp_path / "j.ptz").read(
        "manifest.json"))["quantize"]["arrays"]
    mt = json.loads(zipfile.ZipFile(tmp_path / "t.ptz").read(
        "manifest.json"))["quantize"]["arrays"]
    assert mj == mt


def test_bf16_rounding_equals_ml_dtypes():
    bits = np.concatenate([
        np.arange(0, 1 << 32, 65519, dtype=np.uint64).astype(np.uint32),
        np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000,
                  0x7F800001, 0xFF800001, 0x7FC00000, 0x7FFFFFFF,
                  0xFFFFFFFF, 0x7F7FFFFF, 0xFF7FFFFF, 0x3F808000,
                  0x3F818000, 0x3F80FFFF, 0x00008000, 0x00018000,
                  0x007FFFFF, 0x7F7F8000], np.uint32)])
    f = bits.view(np.float32)
    with np.errstate(invalid="ignore"):  # ml_dtypes warns on NaN casts
        want = f.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(_bf16_bits(f), want)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_quantize_params_equal_the_reference(mode):
    rng = np.random.RandomState(3)
    tree = {"w": rng.randn(32, 16).astype(np.float32),
            "z": np.zeros((16, 16), np.float32),
            "b": rng.randn(16).astype(np.float32),
            "conv": rng.randn(3, 3, 4, 8).astype(np.float32),
            "ids": np.arange(4, dtype=np.int32)}
    want, wmeta = jquantize(tree, mode)
    got, gmeta = quantize_params(tree, mode)
    assert gmeta == wmeta and sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k


# ---------------------------------------------------------------------------
# deploy behaviours (tests/test_deploy_quant.py, tests/test_deploy_aot.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_quantized_parameters_within_half_a_step(tmp_path, trained, mode):
    """Each parameter a quantized bundle loads is within half a
    quantization step of the value it was merged from, the step computed
    from that value alone: int8 (ndim >= 2, size >= 256) the channel's max
    |w| / 127 over the last axis; bfloat16 at most 2**-8 |w|."""
    m = load_inference_model(_port_bundle(tmp_path / "q.ptz", trained, mode),
                             device="cpu")
    n_int8 = 0
    for name, p in m.params.items():
        w = trained[name].astype(np.float64)
        got = p.numpy().astype(np.float64)
        if mode == "int8" and w.ndim >= 2 and w.size >= 256:
            n_int8 += 1
            half = (0.5 * np.abs(w).max(axis=tuple(range(w.ndim - 1)),
                                        keepdims=True) / 127.0
                    + 2.0 ** -22 * np.abs(w))
        else:
            half = 2.0 ** -8 * np.abs(w)
        assert np.all(np.abs(got - w) <= half), name
    # int8: the lstm's input and recurrent weights; the rest bfloat16
    assert n_int8 == (2 if mode == "int8" else 0)


def test_bundle_infer_equals_the_merged_topology(tmp_path, trained):
    _, topo = _net(tnn, "cpu")
    params = params_from_jax(trained, "cpu")
    path = merge_model(str(tmp_path / "m.ptz"), topo, params, {}, name="m")
    m = load_inference_model(path, device="cpu")
    assert m.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in m.params.values())
    feed = _seq_feed(np.random.RandomState(4), 5)
    want, _ = topo.apply(params, {}, feed, outputs=["out"])
    np.testing.assert_array_equal(m.infer(feed)["out"],
                                  want["out"].value.detach().numpy())
    assert m.model_config.dtype_policy == "float32"


def test_quant_gate_rejects_on_tight_tolerance(tmp_path, trained):
    with pytest.raises(ValueError, match="rejected"):
        _, topo = _net(tnn, "cpu")
        merge_model(str(tmp_path / "never.ptz"), topo,
                    params_from_jax(trained, "cpu"), {}, quantize="int8",
                    quantize_tol=1e-12)
    assert not (tmp_path / "never.ptz").exists()
    with pytest.raises(ValueError, match="quantize must be one of"):
        merge_model(str(tmp_path / "x.ptz"), topo,
                    params_from_jax(trained, "cpu"), {}, quantize="fp8")


def _rewrite(bundle, dst, mutate_arrays=None, mutate_member=None):
    with zipfile.ZipFile(bundle) as z:
        members = {i.filename: z.read(i.filename) for i in z.infolist()}
    if mutate_arrays is not None:
        arrays = dict(np.load(io.BytesIO(members["params.npz"]),
                              allow_pickle=False))
        buf = io.BytesIO()
        np.savez_compressed(buf, **mutate_arrays(arrays))
        members["params.npz"] = buf.getvalue()
    with zipfile.ZipFile(dst, "w", zipfile.ZIP_DEFLATED) as z:
        for name, data in members.items():
            data = mutate_member(name, data) if mutate_member else data
            if data is not None:
                z.writestr(name, data)
    return str(dst)


def test_scale_member_validation_is_typed(tmp_path, trained):
    i8 = _port_bundle(tmp_path / "i8.ptz", trained, "int8")
    qarrays = json.loads(zipfile.ZipFile(i8).read(
        "manifest.json"))["quantize"]["arrays"]
    name = next(n for n, m in qarrays.items() if m["mode"] == "int8")
    sname = name + "::scale"

    def drop(a):
        a.pop(sname)
        return a

    def misshape(a):
        a[sname] = a[sname].reshape(-1)[:1]
        return a

    def poison(a):
        s = a[sname].copy()
        s.flat[0] = np.nan
        a[sname] = s
        return a

    for i, mutate in enumerate((drop, misshape, poison)):
        bad = _rewrite(i8, tmp_path / f"bad{i}.ptz", mutate_arrays=mutate)
        with pytest.raises(BundleCorruptError) as ei:
            load_inference_model(bad, device="cpu")
        assert sname in str(ei.value.member), ei.value


def test_bundle_corruption_is_typed_and_names_the_member(tmp_path, trained):
    bundle = _port_bundle(tmp_path / "m.ptz", trained, None)
    load_inference_model(bundle, device="cpu")
    data = open(bundle, "rb").read()
    torn = tmp_path / "torn.ptz"
    torn.write_bytes(data[: len(data) // 2])
    with pytest.raises(BundleCorruptError) as ei:
        load_inference_model(str(torn), device="cpu")
    assert ei.value.member is None
    for member in ("params.npz", "model.pb"):
        bad = _rewrite(bundle, tmp_path / f"bad-{member}.zip",
                       mutate_member=lambda n, d, m=member:
                       d[: len(d) // 2] if n == m else d)
        with pytest.raises(BundleCorruptError) as ei:
            load_inference_model(bad, device="cpu")
        assert ei.value.member == member, ei.value
    gone = _rewrite(bundle, tmp_path / "gone.ptz", mutate_member=lambda n, d:
                    None if n == "params.npz" else d)
    with pytest.raises(BundleCorruptError) as ei:
        load_inference_model(gone, device="cpu")
    assert ei.value.member == "params.npz"
    nojson = _rewrite(bundle, tmp_path / "nojson.ptz",
                      mutate_member=lambda n, d:
                      b"{not json" if n == "manifest.json" else d)
    with pytest.raises(BundleCorruptError) as ei:
        load_inference_model(nojson, device="cpu")
    assert ei.value.member == "manifest.json"
    flipped = tmp_path / "flipped.ptz"
    flipped.write_bytes(data)
    chaos.corrupt_file(str(flipped))
    with pytest.raises((BundleCorruptError, ValueError)):
        load_inference_model(str(flipped), device="cpu")
    notbundle = tmp_path / "not.ptz"
    with zipfile.ZipFile(notbundle, "w") as z:
        z.writestr("manifest.json", json.dumps({"magic": "something_else"}))
    with pytest.raises(ValueError, match="not a paddle_tpu model bundle"):
        load_inference_model(str(notbundle), device="cpu")
    garbage = tmp_path / "garbage.ptz"
    garbage.write_bytes(b"this is not a zip archive")
    with pytest.raises(BundleCorruptError):
        load_inference_model(str(garbage), device="cpu")
    with pytest.raises(FileNotFoundError):
        load_inference_model(str(tmp_path / "absent.ptz"), device="cpu")


@pytest.fixture
def classifier(tmp_path, trained):
    """A bundle of the whole training graph (outputs: cost), so the
    ``label`` slot is reachable only from ``cost``."""
    cost, _ = _net(tnn, "cpu")
    topo = tnn.Topology(cost, device="cpu")
    path = merge_model(str(tmp_path / "c.ptz"), topo,
                       params_from_jax(trained, "cpu"), {}, name="c")
    return load_inference_model(path, device="cpu")


def test_infer_empty_rows_and_missing_slot(classifier):
    m = classifier
    empty = {"x": (np.zeros((0, T, D), np.float32), np.zeros((0,), np.int32))}
    out = m.infer(empty, outputs=["out"])
    assert out["out"].shape == (0, C) and out["out"].dtype == np.float32
    with pytest.raises(ValueError, match="missing input slot"):
        m.infer({}, outputs=["out"])
    with pytest.raises(ValueError, match=r"missing input slot.*label"):
        m.infer(_seq_feed(np.random.RandomState(0), 2))
    m.infer(_seq_feed(np.random.RandomState(0), 2), outputs=["out"])
    with pytest.raises(ValueError, match="mixes zero-row"):
        m.infer({**empty, "label": np.zeros((2, 1), np.int32)})


def test_concurrent_infer_with_mixed_shapes(classifier):
    m = classifier
    rng = np.random.RandomState(5)
    feeds = {b: _seq_feed(rng, b, t=t) for b, t in ((1, 3), (2, 6), (5, 9))}
    expected = {b: m.infer(f, outputs=["out"])["out"]
                for b, f in feeds.items()}
    barrier = threading.Barrier(6)
    failures = []

    def hammer(i):
        b = sorted(feeds)[i % 3]
        barrier.wait(timeout=60)
        try:
            for _ in range(6):
                got = m.infer(feeds[b], outputs=["out"])["out"]
                np.testing.assert_array_equal(got, expected[b])
        except Exception as e:  # noqa: BLE001
            failures.append((i, repr(e)))

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not failures, failures
    assert all(not t.is_alive() for t in threads)


def test_prime_fingerprint_and_refusals(tmp_path, trained):
    path = _port_bundle(tmp_path / "m.ptz", trained, None)
    m = load_inference_model(path, device="cpu")
    feed = _seq_feed(np.random.RandomState(6), 2)
    assert m.prime(feed) == "compiled"
    assert m.prime(feed) == "warm"
    assert m.prime(_seq_feed(np.random.RandomState(6), 4)) == "compiled"
    assert m.compile_events == 2
    assert feed_signature(feed) != feed_signature(
        {"x": feed["x"][:1]}), "tuple arity is part of the signature"
    assert m.fingerprint.startswith("bundle:")
    assert load_inference_model(path, device="cpu").fingerprint \
        == m.fingerprint  # identical payloads share it
    other = _port_bundle(tmp_path / "o.ptz",
                         {k: v + 1 for k, v in trained.items()}, None)
    assert load_inference_model(other, device="cpu").fingerprint \
        != m.fingerprint
    # the compile cache is ported: on the CPU a primed signature runs the
    # plain versions, no kernel library, so the cache has nothing to give
    from paddle_tpu_torch.config.compile_cache import CompileCacheDir

    assert m.prime(_seq_feed(np.random.RandomState(6), 8),
                   cache=CompileCacheDir(str(tmp_path / "cc"))) == "compiled"
    assert m.compile_events == 3
    # and the architecture fingerprint every weight version shares
    arch = load_inference_model(path, device="cpu", arch_fingerprint=True)
    assert not arch.fingerprint.startswith("bundle:")
    assert arch.fingerprint == load_inference_model(
        other, device="cpu", arch_fingerprint=True).fingerprint
    with pytest.raises(ConfigError, match="Queue 1 item 9\\b"):
        load_inference_model(path, device="cpu", int8_in_trace=True)
    _, topo = _net(tnn, "cpu")
    with pytest.raises(ConfigError, match="Queue 1 item 9\\b"):
        merge_model(str(tmp_path / "l.ptz"), topo,
                    params_from_jax(trained, "cpu"), {}, example_feed=feed)
    with pytest.raises(ValueError, match="missing"):
        merge_model(str(tmp_path / "p.ptz"), topo, {}, {})


def test_a_bundle_rebuilds_without_the_model_code(tmp_path, trained):
    """The proto alone rebuilds the graph: the loaded model is an
    ``InferenceModel`` over the recorded calls, bundle metadata kept."""
    _, topo = _net(tnn, "cpu")
    path = merge_model(str(tmp_path / "m.ptz"), topo,
                       params_from_jax(trained, "cpu"), {}, name="m",
                       meta={"owner": "x", "magic": "ignored"})
    tnn.reset_naming()
    m = load_inference_model(path, device="cpu")
    assert isinstance(m, InferenceModel)
    assert m.manifest["owner"] == "x"
    assert m.manifest["magic"] == "paddle_tpu.bundle.v1"
    assert [l.name for l in m.topology.layers] == ["x", "lstm", "pool",
                                                   "out"]


# ---------------------------------------------------------------------------
# bucket-mode InferenceServer over an InferenceModel
# ---------------------------------------------------------------------------


def test_bucket_server_replies_equal_solo_infer(tmp_path, trained):
    """Mixed-length requests of 1-4 rows, submitted at once: each reply
    equals ``infer`` of that request alone, unpadded, bit for bit (the
    batch pads rows up to a bucket and steps up to the feeder's length
    bucket)."""
    m = load_inference_model(_port_bundle(tmp_path / "m.ptz", trained, None),
                             device="cpu")
    rng = np.random.RandomState(7)
    reqs = []
    for _ in range(24):
        rows, t = rng.randint(1, 5), rng.randint(2, 12)
        reqs.append(_seq_feed(rng, rows, t=t))
    srv = InferenceServer(m, max_batch=8, batch_delay_ms=20.0)
    srv.start(warmup_feed=[_seq_feed(rng, 1, t=t) for t in (8, 16)])
    try:
        futs = [srv.submit(f) for f in reqs]
        for f, feed in zip(futs, reqs):
            np.testing.assert_array_equal(f.result(60)["out"],
                                          m.infer(feed)["out"])
        hz = srv.healthz()
        assert hz["counters"]["completed"] == len(reqs)
        assert hz["counters"]["batches"] < len(reqs)  # requests coalesced
    finally:
        srv.close()


def test_bucket_warmup_primes_each_bucket_once(tmp_path, trained):
    m = load_inference_model(_port_bundle(tmp_path / "m.ptz", trained, None),
                             device="cpu")
    calls = []
    prime = m.prime
    m.prime = lambda feed, outputs=None, cache=None: (
        calls.append(feed_signature(feed)) or prime(feed, outputs, cache))
    srv = InferenceServer(m, max_batch=8)
    srv.start()  # the bundle's example feed
    srv.close()
    assert len(calls) == 4 and len(set(calls)) == 4  # buckets 1, 2, 4, 8
    assert m.compile_events == 4
    assert srv.metrics.count("warmup_compiles") == 4
    srv2 = InferenceServer(m, max_batch=8)
    srv2.start()  # every signature already warm: nothing paid
    srv2.close()
    assert m.compile_events == 4 and srv2.metrics.count(
        "warmup_compiles") == 0


def test_bucket_zero_row_request_replies_empty_inline(classifier):
    m = classifier
    srv = InferenceServer(m, max_batch=8, outputs=["out"])
    srv.start(warmup_feed=_seq_feed(np.random.RandomState(0), 1))
    try:
        before = m.compile_events
        ran = []
        run = m._run
        m._run = lambda names, feed: ran.append(names) or run(names, feed)
        fut = srv.submit({"x": (np.zeros((0, T, D), np.float32),
                                np.zeros((0,), np.int32))})
        out = fut.result(5)
        assert out["out"].shape == (0, C)
        assert ran == [] and m.compile_events == before  # primed shapes
        assert srv.healthz()["counters"]["batches"] == 0
        with pytest.raises(InvalidRequestError, match="malformed empty"):
            srv.submit({"y": np.zeros((0, 3), np.float32)})
        # a tier's outputs override the server's
        got = srv._runner(_seq_feed(np.random.RandomState(0), 1),
                          {"outputs": ["pool"]})
        assert set(got) == {"pool"}
    finally:
        srv.close()
