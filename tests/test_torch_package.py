"""The port package stands alone: paddle_tpu_torch imports neither jax nor
the JAX package ``paddle_tpu``, nor ``google.protobuf`` or ``ml_dtypes``
(the machine with the card has neither), runs in a process that never loads
them, and its entry points refuse to drop quietly to the CPU."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "paddle_tpu_torch")


def _py_files():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_tpu")


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    files = list(_py_files())
    assert len(files) >= 15
    rel = {os.path.relpath(p, PKG) for p in files}
    for mod in ("nn/graph.py", "nn/layers.py", "nn/__init__.py",
                "models/text.py", "ops/kernels/lstm.py", "utils/error.py",
                "param/convert.py", "nn/recurrent.py", "nn/projections.py",
                "nn/steps.py", "v2/networks.py",
                "ops/kernels/topk_logits.py", "ops/kernels/bigru.py",
                "ops/kernels/logsumexp.py", "ops/rnn_fused.py",
                "ops/losses.py", "utils/flags.py", "serving/server.py",
                "serving/worker.py", "serving/breaker.py",
                "serving/metrics.py", "serving/errors.py",
                "obs/__init__.py", "obs/registry.py", "utils/log.py",
                "resilience/__init__.py", "resilience/chaos.py",
                "__main__.py", "trainer/trainer.py", "trainer/checkgrad.py",
                "param/hooks.py", "resilience/checkpoint_io.py",
                "resilience/guard.py", "data/feeder.py", "data/reader.py",
                "data/datasets.py", "data/native.py", "data/formats.py",
                "data/provider.py", "evaluators/evaluators.py",
                "utils/registry.py", "ops/conv.py", "ops/misc.py",
                "nn/layers_extra.py", "nn/layers_extra2.py",
                "models/vision.py", "models/image_bench.py",
                "ops/crf.py", "ops/sequence.py", "ops/sparse.py",
                "ops/ctc.py", "models/recommender.py",
                "datapipe/__init__.py", "datapipe/sampler.py",
                "datapipe/shards.py", "datapipe/iterator.py",
                "datapipe/packing.py", "datapipe/cli.py", "nn/feeds.py",
                "serving/feeds.py", "proto/__init__.py",
                "proto/model_config_pb2.py", "config/__init__.py",
                "config/capture.py", "config/config_parser.py",
                "config/deploy.py", "serving/cli.py", "serving/slots.py",
                "utils/devices.py", "v2/__init__.py", "v2/activation.py",
                "v2/attr.py", "v2/data_feeder.py", "v2/data_type.py",
                "v2/dataset.py", "v2/evaluator.py", "v2/event.py",
                "v2/inference.py", "v2/layer.py", "v2/minibatch.py",
                "v2/optimizer.py", "v2/parameters.py", "v2/plot.py",
                "v2/pooling.py", "v2/reader.py", "v2/topology.py",
                "v2/trainer.py", "demo/seqToseq/train.py",
                "demo/gan/train.py", "demo/model_zoo/classify.py",
                "config/compile_cache.py", "obs/journal.py",
                "resilience/integrity.py", "publish/__init__.py",
                "publish/publisher.py", "serving/reload.py",
                "serving/fleet.py", "serving/tenancy.py",
                "serving/router.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/distributed.py",
                "parallel/launcher.py", "parallel/sharding.py",
                "parallel/api.py", "parallel/embedding.py",
                "pserver/__init__.py", "pserver/table.py",
                "pserver/lookup.py", "pserver/apply.py", "pserver/tier.py"):
        assert mod in rel, mod
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [] if node.level else [node.module or ""]
            else:
                continue
            bad += [(os.path.relpath(path, ROOT), n) for n in names
                    if _forbidden(n)]
    assert not bad, bad


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module or ""


@pytest.mark.parametrize("script", [
    "chip_smoke.py", "chip_probe.py", "tests/torch_seqtoseq_net.py",
    "tests/torch_text_nets.py", "tests/torch_golden_nets.py",
    "tests/torch_layer_cases.py", "tests/torch_sparse_nets.py",
    "tests/torch_nested_nets.py", "tests/torch_v2_seqtoseq.py"])
def test_card_scripts_and_shared_builders_import_no_jax(script):
    """The card's scripts, and the builders they (and the card tests)
    share with the CPU tests, import neither jax nor the JAX package: the
    machine with the card has no JAX."""
    bad = [n for n in _imports(os.path.join(ROOT, script)) if _forbidden(n)]
    assert not bad, bad


def _card_lacks(name: str) -> bool:
    """A package the machine with the card does not have."""
    return (name.split(".")[0] == "ml_dtypes"
            or name == "google" or name.startswith("google.protobuf"))


def test_no_module_of_the_port_imports_protobuf_or_ml_dtypes():
    bad = [(os.path.relpath(p, ROOT), n) for p in _py_files()
           for n in _imports(p) if _card_lacks(n)]
    assert not bad, bad
    assert _card_lacks("google.protobuf.text_format")
    assert _card_lacks("ml_dtypes") and not _card_lacks("numpy")


@pytest.mark.parametrize("script", ["chip_smoke.py", "chip_probe.py"])
def test_card_scripts_import_no_protobuf_or_ml_dtypes(script):
    bad = [n for n in _imports(os.path.join(ROOT, script)) if _card_lacks(n)]
    assert not bad, bad


def test_serve_subcommand_runs_without_jax_protobuf_or_ml_dtypes(tmp_path):
    """``python -m paddle_tpu_torch serve --serve_smoke=4 --device=cpu`` on
    a bundle the port merges in the same fresh process, with any import of
    jax, the JAX package, ``google.protobuf`` or ``ml_dtypes`` made to
    fail: both exit cleanly and none of them is ever loaded."""
    bundle = str(tmp_path / "m.ptz")
    code = textwrap.dedent(f"""
        import importlib.abc, runpy, sys

        BLOCKED = ("jax", "jaxlib", "paddle_tpu", "ml_dtypes",
                   "google.protobuf")

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if any(name == b or name.startswith(b + ".")
                       for b in BLOCKED):
                    raise ImportError(f"{{name}} is blocked")
                return None

        sys.meta_path.insert(0, Block())
        import paddle_tpu_torch.nn as nn
        from paddle_tpu_torch.config import merge_model
        from paddle_tpu_torch.models.text import lstm_benchmark_net
        nn.reset_naming()
        _, logits = lstm_benchmark_net(30, emb_dim=4, hid_dim=6)
        topo = nn.Topology(logits, device="cpu")
        params, state = topo.init(0)
        merge_model({bundle!r}, topo, params, state, quantize="int8")
        sys.argv = ["paddle_tpu_torch", "serve", "--serve_bundle={bundle}",
                    "--serve_smoke=4", "--device=cpu",
                    "--serve_deadline_ms=60000"]
        try:
            runpy.run_module("paddle_tpu_torch", run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        print("LOADED", sorted(m for m in sys.modules
                               if any(m == b or m.startswith(b + ".")
                                      for b in BLOCKED)))
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "LOADED []", out.stdout
    import json

    first, last = json.loads(lines[0]), json.loads(lines[-2])
    assert first["ready"] is True
    assert last["counters"]["completed"] == 4
    assert last["counters"]["shed"] == 0


def test_v2_script_and_demo_copy_run_without_jax(tmp_path):
    """The v2 seqToseq script (create, SGD, a tar, infer) and the seqToseq
    demo copy, in a fresh process where any import of jax or the JAX
    package fails: both run and neither is ever loaded."""
    code = textwrap.dedent(f"""
        import importlib.abc, io, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"):
                    raise ImportError(f"{{name}} is blocked")
                return None

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {os.path.join(ROOT, "tests")!r})
        import paddle_tpu_torch.nn as nn
        import paddle_tpu_torch.v2 as paddle
        from paddle_tpu_torch.demo.seqToseq import train as demo
        from torch_v2_seqtoseq import (FEEDING, v2_seqtoseq_generator,
                                       v2_seqtoseq_reader,
                                       v2_seqtoseq_trainer, v2_test_sources)
        paddle.init(["--device=cpu"])
        cost = v2_seqtoseq_trainer(paddle, V=30)
        params = paddle.parameters.create(cost)
        trainer = paddle.trainer.SGD(
            cost=cost, parameters=params,
            update_equation=paddle.optimizer.Adam(learning_rate=1e-3))
        trainer.train(v2_seqtoseq_reader(paddle, 30, 8, 4), feeding=FEEDING)
        buf = io.BytesIO()
        trainer.save_parameter_to_tar(buf)
        nn.reset_naming()
        gen = v2_seqtoseq_generator(paddle, V=30)
        gparams = paddle.parameters.create(gen)
        gparams.from_tar(io.BytesIO(buf.getvalue()))
        ids = paddle.infer(output_layer=gen, parameters=gparams,
                           input=v2_test_sources(paddle, 30, 2), field="id")
        assert ids.shape == (2, 3, 8), ids.shape
        res = demo.main(["--n", "8", "--batch-size", "4", "--dict-size",
                         "30", "--emb-dim", "8", "--hid-dim", "8",
                         "--device", "cpu"])
        assert len(res["losses"]) == 2
        print("LOADED", sorted(m for m in sys.modules
                               if m.split(".")[0] in ("jax", "jaxlib",
                                                      "paddle_tpu")))
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "LOADED []", out.stdout


def test_ast_scan_tells_the_port_apart_from_the_jax_package():
    assert _forbidden("paddle_tpu") and _forbidden("paddle_tpu.ops.decode")
    assert _forbidden("jax.numpy")
    assert not _forbidden("paddle_tpu_torch")
    assert not _forbidden("paddle_tpu_torch.ops.decode")


def test_port_runs_a_cpu_decode_without_loading_jax():
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from paddle_tpu_torch.models import Seq2SeqAttention
        from paddle_tpu_torch.ops import compute_dtype_scope
        m = Seq2SeqAttention(src_vocab=40, trg_vocab=50, emb_dim=8,
                             enc_dim=8, dec_dim=8, att_dim=8, device="cpu")
        p = m.init(seed=1)
        src = np.full((2, 5), 3, np.int64)
        with compute_dtype_scope("float32"):
            toks, scores = m.beam_search(p, src, np.array([5, 2]),
                                         beam_size=2, max_len=4)
        assert tuple(toks.shape) == (2, 2, 4)
        print("JAX_LOADED", any(k == "jax" or k.startswith("jax.")
                                for k in sys.modules))
        print("JAX_PACKAGE_LOADED", "paddle_tpu" in sys.modules)
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "JAX_LOADED False" in out.stdout, out.stdout
    assert "JAX_PACKAGE_LOADED False" in out.stdout, out.stdout


def test_every_module_imports_without_jax_and_builds_nothing():
    """Importing every module of the port (the nn DSL, its recurrent
    groups, the LSTM and K8 kernels included) loads neither jax nor the JAX
    package, and starts no nvcc."""
    mods = sorted(
        "paddle_tpu_torch." + os.path.relpath(p, PKG)[:-3].replace(
            os.sep, ".").replace(".__init__", "")
        for p in _py_files())
    code = textwrap.dedent(f"""
        import importlib, os, sys
        for m in {mods!r}:
            importlib.import_module(m)
        from paddle_tpu_torch.ops.kernels.build import LIBRARIES, BUILD_DIR
        print("LIBRARIES", sorted(LIBRARIES))
        print("LOADED", [n for n, l in LIBRARIES.items() if l._lib is not None])
        print("JAX_LOADED", any(k == "jax" or k.startswith("jax.")
                                for k in sys.modules))
        print("JAX_PACKAGE_LOADED", "paddle_tpu" in sys.modules)
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "'lstm_backward', 'lstm_forward'" in out.stdout, out.stdout
    assert "'topk_lse_logits'" in out.stdout, out.stdout
    assert "LOADED []" in out.stdout, out.stdout
    assert "JAX_LOADED False" in out.stdout, out.stdout
    assert "JAX_PACKAGE_LOADED False" in out.stdout, out.stdout


def test_data_subcommand_runs_without_loading_jax(tmp_path):
    """``python -m paddle_tpu_torch data pack`` then ``data verify`` in a
    fresh process: both exit 0 and neither loads jax or the JAX
    package."""
    (tmp_path / "toy_readers.py").write_text(
        "from paddle_tpu_torch.data import datasets\n"
        "train = datasets.uci_housing('train')\n")
    code = textwrap.dedent(f"""
        import sys
        from paddle_tpu_torch.__main__ import main
        out = {str(tmp_path / "set")!r}
        assert main(["data", "pack", out, "--reader", "toy_readers:train",
                     "--shards", "3", "--limit", "20"]) == 0
        assert main(["data", "verify", out]) == 0
        print("JAX_LOADED", any(k == "jax" or k.startswith("jax.")
                                for k in sys.modules))
        print("JAX_PACKAGE_LOADED", "paddle_tpu" in sys.modules)
    """)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "verified 20 record(s) across 3 shard(s)" in out.stdout
    assert "JAX_LOADED False" in out.stdout, out.stdout
    assert "JAX_PACKAGE_LOADED False" in out.stdout, out.stdout


def test_entry_points_raise_without_a_card_unless_cpu_is_asked(monkeypatch):
    from paddle_tpu_torch import nn, resolve_device
    from paddle_tpu_torch.models import (Seq2SeqAttention, lstm_benchmark_net,
                                         params_from_jax)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Seq2SeqAttention(src_vocab=10, trg_vocab=10, emb_dim=4, enc_dim=4,
                         dec_dim=4, att_dim=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({})
    nn.reset_naming()
    cost, _ = lstm_benchmark_net(20, emb_dim=4, hid_dim=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nn.Topology(cost)
    assert nn.Topology(cost, device="cpu").device.type == "cpu"
    assert nn.params_from_jax is params_from_jax
    m = Seq2SeqAttention(src_vocab=10, trg_vocab=10, emb_dim=4, enc_dim=4,
                         dec_dim=4, att_dim=4, device="cpu")
    assert m.device.type == "cpu"


def test_kernel_modules_build_nothing_at_import():
    """Importing the kernel modules starts no nvcc and loads no library
    (this machine may have no CUDA toolkit at all)."""
    from paddle_tpu_torch.ops.kernels.build import LIBRARIES

    for lib in LIBRARIES.values():
        assert lib._lib is None or torch.cuda.is_available()
