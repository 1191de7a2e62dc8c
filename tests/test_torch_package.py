"""The port package stands alone: paddle_tpu_torch imports neither jax nor
the JAX package ``paddle_tpu``, runs in a process that never loads jax, and
its entry points refuse to drop quietly to the CPU."""

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
                "data/datasets.py", "evaluators/evaluators.py",
                "utils/registry.py", "ops/conv.py", "ops/misc.py",
                "nn/layers_extra.py", "nn/layers_extra2.py",
                "models/vision.py", "models/image_bench.py",
                "ops/crf.py", "ops/sequence.py", "ops/sparse.py",
                "ops/ctc.py", "models/recommender.py"):
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
    "tests/torch_layer_cases.py", "tests/torch_sparse_nets.py"])
def test_card_scripts_and_shared_builders_import_no_jax(script):
    """The card's scripts, and the builders they (and the card tests)
    share with the CPU tests, import neither jax nor the JAX package: the
    machine with the card has no JAX."""
    bad = [n for n in _imports(os.path.join(ROOT, script)) if _forbidden(n)]
    assert not bad, bad


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
