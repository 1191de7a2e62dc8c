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


def test_entry_points_raise_without_a_card_unless_cpu_is_asked(monkeypatch):
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.models import Seq2SeqAttention, params_from_jax

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Seq2SeqAttention(src_vocab=10, trg_vocab=10, emb_dim=4, enc_dim=4,
                         dec_dim=4, att_dim=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({})
    m = Seq2SeqAttention(src_vocab=10, trg_vocab=10, emb_dim=4, enc_dim=4,
                         dec_dim=4, att_dim=4, device="cpu")
    assert m.device.type == "cpu"


def test_kernel_modules_build_nothing_at_import():
    """Importing the kernel modules starts no nvcc and loads no library
    (this machine may have no CUDA toolkit at all)."""
    from paddle_tpu_torch.ops.kernels.build import LIBRARIES

    for lib in LIBRARIES.values():
        assert lib._lib is None or torch.cuda.is_available()
