"""The port's command line, ``python -m paddle_tpu_torch --job=...
--config=...`` (the train/test/checkgrad/time/help/bad-args cases of
tests/test_cli.py), on ``tests/torch_textclf_conf.py`` shrunk through its
``TORCH_TEXTCLF_*`` variables and run with ``--device=cpu``.  The test
job's cost is held against the JAX trainer's ``test`` from the same
checkpoint (rtol 1e-5, the reference's f32 RNN tolerance).  The image
config ``tests/torch_resnet_conf.py`` (resnet at depth 8 through
``TORCH_RESNET_*``) trains, tests, resumes and times the same way."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.__main__ import main
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.flags import FLAGS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(ROOT, "tests", "torch_textclf_conf.py")
RESNET_CONF = os.path.join(ROOT, "tests", "torch_resnet_conf.py")
RESNET_SMALL = {"DEPTH": 8, "BATCH": 8, "N": 16, "TEST_N": 8}
SMALL = {"VOCAB": 48, "EMB": 8, "HID": 12, "BATCH": 6, "T": 10, "N": 18,
         "TEST_N": 12}


@pytest.fixture(autouse=True)
def small_conf(monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setenv(f"TORCH_TEXTCLF_{k}", str(v))
    # flags are process-global: restore every one around each test
    keep = FLAGS.as_dict()
    FLAGS.log_period = 0
    yield
    for k, v in keep.items():
        setattr(FLAGS, k, v)


def _args(*extra):
    return [f"--config={CONF}", "--device=cpu", *extra]


def test_cli_train_then_test_roundtrip(tmp_path, capsys):
    assert main(_args("--job=train", "--num_passes=2",
                      f"--save_dir={tmp_path}")) == 0
    assert sorted(os.listdir(tmp_path)) == ["pass-00000", "pass-00001"]
    capsys.readouterr()
    assert main(_args("--job=test", f"--save_dir={tmp_path}")) == 0
    out = capsys.readouterr().out
    got = eval(out.strip().splitlines()[-1])  # the printed result dict
    assert set(got) == {"cost"} and np.isfinite(got["cost"])
    # the JAX trainer's test of the same checkpoint
    import paddle_tpu.data as jdata
    import paddle_tpu.nn as jnn
    from paddle_tpu.models.text import lstm_benchmark_net
    from paddle_tpu.trainer import SGDTrainer

    jnn.reset_naming()
    cost, _ = lstm_benchmark_net(48, emb_dim=8, hid_dim=12, num_layers=2)
    jtr = SGDTrainer(cost, seed=0)
    jtr.load(str(tmp_path), 1)
    want = jtr.test(
        jdata.batch(jdata.datasets.imdb("test", vocab_size=48, n=12), 6),
        feeder=jdata.DataFeeder({"words": "ids_seq", "label": "int"},
                                buckets=(10,), max_len=10))
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-5)


def test_cli_test_pass_and_missing_checkpoint(tmp_path):
    assert main(_args("--job=train", "--num_passes=2",
                      f"--save_dir={tmp_path}")) == 0
    assert main(_args("--job=test", f"--save_dir={tmp_path}",
                      "--test_pass=0")) == 0
    with pytest.raises(ConfigError, match="no checkpoint"):
        main(_args("--job=test", f"--save_dir={tmp_path / 'empty'}",
                   "--test_pass=-1"))


def test_cli_start_pass_resumes_from_the_previous_pass(tmp_path, capsys):
    """``--start_pass=1`` loads pass 0 and trains pass 1 only, to the
    uninterrupted run's pass-1 checkpoint bit for bit."""
    full, part = tmp_path / "full", tmp_path / "part"
    assert main(_args("--job=train", "--num_passes=2",
                      f"--save_dir={full}")) == 0
    assert main(_args("--job=train", "--num_passes=1",
                      f"--save_dir={part}")) == 0
    assert main(_args("--job=train", "--num_passes=2", "--start_pass=1",
                      f"--save_dir={part}")) == 0
    a = np.load(full / "pass-00001" / "params.npz")
    b = np.load(part / "pass-00001" / "params.npz")
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_cli_resume_auto_keep_last_n_and_reader_retries(tmp_path):
    args = _args("--job=train", "--num_passes=2", f"--save_dir={tmp_path}",
                 "--resume=auto", "--keep_last_n=1", "--reader_retries=2")
    assert main(list(args)) == 0
    assert sorted(os.listdir(tmp_path)) == ["pass-00001"]
    assert main(list(args)) == 0  # nothing left to do


def test_cli_checkgrad(capsys):
    assert main(_args("--job=checkgrad", "--compute_dtype=float32")) == 0
    assert "checkgrad OK (15 parameters" in capsys.readouterr().out


def test_cli_time(capsys):
    assert main(_args("--job=time", "--time_batches=2")) == 0
    assert "ms/batch over 2 batches" in capsys.readouterr().out


def test_cli_help_lists_the_ported_flags_only(capsys):
    assert main(["--help"]) == 0
    out = capsys.readouterr().out
    assert "usage: python -m paddle_tpu_torch" in out
    for flag in ("--device", "--save_dir", "--resume", "--keep_last_n",
                 "--guard_nonfinite", "--max_bad_steps", "--num_passes",
                 "--time_batches", "--checkgrad_eps", "--test_pass",
                 "--fused_apply", "--show_parameter_stats_period",
                 "--data_pack", "--data_shards", "--shuffle_seed",
                 "--amp", "--loss_scale", "--loss_scale_growth",
                 "--loss_scale_max", "--remat", "--prefetch_depth",
                 "--publish_dir", "--publish_every", "--compile_cache_dir",
                 "--scrub_every_s", "--obs_journal", "--pserver_axis",
                 "--mesh_shape", "--mesh_axes", "--pserver_pad_vocab"):
        assert f"{flag}=" in out, flag
    for flag in ("--sdc_check_every", "--dcn_axis"):
        assert f"{flag}=" not in out, flag
    assert "-m paddle_tpu_torch data {pack|verify}" in out
    assert "-m paddle_tpu_torch serve --serve_bundle=" in out
    for sub in ("lint", "obs", "fsck"):
        assert f"-m paddle_tpu_torch {sub}" not in out
    assert main(["-h", "--job=train"]) == 0


def test_cli_rejects_bad_args():
    with pytest.raises(ConfigError, match="unrecognized"):
        main(_args("--job=train", "--no_such_flag=1"))
    with pytest.raises(ConfigError, match="--job"):
        main(_args("--job=frobnicate"))
    with pytest.raises(ConfigError, match="--config"):
        main(["--job=train", "--config="])


@pytest.mark.parametrize("flag,item", [
    ("--compile_cache_dir=c", 7), ("--mesh_axes=data", 8), ("--check_nan", 9),
    ("--publish_dir=x", 7), ("--publish_every=1", 7),
    ("--pserver_axis=model", 8), ("--mesh_shape=4", 8),
    ("--sdc_check_every=1", 9), ("--scrub_every_s=1", 9),
    ("--obs_timeline=false", 9), ("--profile_dir=p", 9),
    ("--enable_timers", 9), ("--deploy_lint=false", 9),
    ("--serve_preflight", 9)])
def test_cli_unported_flags_name_their_item(flag, item):
    """Item 9 still refuses its flags; the continuous-delivery flags
    (``--compile_cache_dir``, ``--publish_dir``, ``--publish_every``,
    ``--scrub_every_s``) and the mesh and pserver flags (``--mesh_shape``,
    ``--mesh_axes``, ``--pserver_axis``) are ported: each parses into
    ``FLAGS`` and is refused no more.  Item 8's ``--dcn_axis`` still names
    its part (the dcn hierarchy)."""
    from paddle_tpu_torch.utils.flags import (FLAGS, NOT_PORTED_FLAGS,
                                              parse_flags)

    name, _, value = flag[2:].partition("=")
    if name in ("mesh_axes", "mesh_shape"):
        with pytest.raises(ConfigError, match="item 8.*hierarchy|"
                           "hierarchy.*item 8"):
            main(_args("--job=train", "--dcn_axis=dcn"))
    if name in ("compile_cache_dir", "publish_dir", "publish_every",
                "scrub_every_s", "mesh_axes", "pserver_axis",
                "mesh_shape"):
        assert name not in NOT_PORTED_FLAGS
        before = getattr(FLAGS, name)
        try:
            assert parse_flags([flag]) == []
            assert str(getattr(FLAGS, name)) in (value, f"{value}.0")
        finally:
            setattr(FLAGS, name, before)
        return
    with pytest.raises(ConfigError, match=f"Queue 1 item {item}"):
        main(_args("--job=train", flag))


@pytest.mark.parametrize("sub,item", [("lint", 9), ("obs", 9), ("fsck", 9)])
def test_cli_unported_subcommands_name_their_item(sub, item):
    with pytest.raises(ConfigError, match=f"Queue 1 item {item}"):
        main([sub, "--help"])


def test_cli_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([f"--config={CONF}", "--job=train"])


def test_config_without_get_config_or_cost(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("x = 1\n")
    with pytest.raises(ConfigError, match="get_config"):
        main([f"--config={bad}", "--device=cpu"])
    bad.write_text("def get_config():\n    return {}\n")
    with pytest.raises(ConfigError, match="no 'cost'"):
        main([f"--config={bad}", "--device=cpu"])


def test_module_entry_point_runs_without_jax():
    """``python -m paddle_tpu_torch --help`` in a fresh process loads
    neither jax nor the JAX package."""
    code = ("import sys, runpy; sys.argv = ['x', '--help'];\n"
            "try:\n    runpy.run_module('paddle_tpu_torch', "
            "run_name='__main__')\nexcept SystemExit as e:\n"
            "    assert e.code == 0\n"
            "assert 'jax' not in sys.modules and "
            "'paddle_tpu' not in sys.modules, sorted(sys.modules)\n"
            "print('NO-JAX-OK')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "NO-JAX-OK" in out.stdout and "usage:" in out.stdout


@pytest.fixture
def resnet_conf(monkeypatch):
    for k, v in RESNET_SMALL.items():
        monkeypatch.setenv(f"TORCH_RESNET_{k}", str(v))
    return lambda *extra: [f"--config={RESNET_CONF}", "--device=cpu",
                           "--compute_dtype=float32", *extra]


def test_cli_resnet_train_test_and_resume(resnet_conf, tmp_path, capsys):
    """The image config: two passes (batch-norm state in each checkpoint),
    ``--job=test`` from the last one against the JAX trainer's test of the
    same checkpoint, and ``--start_pass=1`` from pass 0 to the
    uninterrupted run's pass-1 checkpoint bit for bit."""
    full, part = tmp_path / "full", tmp_path / "part"
    assert main(resnet_conf("--job=train", "--num_passes=2",
                            f"--save_dir={full}")) == 0
    state = np.load(full / "pass-00001" / "state.npz")
    assert any("moving_var" in k for k in state.files)
    capsys.readouterr()
    assert main(resnet_conf("--job=test", f"--save_dir={full}")) == 0
    got = eval(capsys.readouterr().out.strip().splitlines()[-1])
    import paddle_tpu.data as jdata
    import paddle_tpu.nn as jnn
    from paddle_tpu.models import resnet_cifar
    from paddle_tpu.trainer import SGDTrainer

    jnn.reset_naming()
    jtr = SGDTrainer(resnet_cifar(depth=8)[0], seed=0)
    jtr.load(str(full), 1)
    want = jtr.test(jdata.batch(jdata.datasets.cifar10("test", n=8), 8),
                    feeder=jdata.DataFeeder({"pixel": "dense",
                                             "label": "int"}))
    # one forward from the same weights and running stats: float32 sums
    # in another order through 8 conv + batch-norm layers
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-5)
    shutil.copytree(full / "pass-00000", part / "pass-00000")
    assert main(resnet_conf("--job=train", "--num_passes=2",
                            "--start_pass=1", f"--save_dir={part}")) == 0
    for fname in ("params.npz", "state.npz", "opt_state.npz"):
        a = np.load(full / "pass-00001" / fname)
        b = np.load(part / "pass-00001" / fname)
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_cli_resnet_time(resnet_conf, capsys):
    assert main(resnet_conf("--job=time", "--time_batches=2")) == 0
    assert "ms/batch over 2 batches" in capsys.readouterr().out


class _Lines(list):
    """A logging handler that keeps the port logger's messages."""

    def __enter__(self):
        import logging

        from paddle_tpu_torch.utils.log import logger

        self.handler = logging.Handler()
        self.handler.emit = lambda r: self.append(r.getMessage())
        logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.utils.log import logger

        logger.removeHandler(self.handler)


def test_cli_data_pack_trains_packed_rows(monkeypatch):
    """``--data_pack`` packs the config's reader and DataFeeder: the steps
    take packed 5-tuple feeds, their losses are finite, and the log says
    packing is on."""
    import paddle_tpu_torch.trainer.trainer as tmod

    feeds, losses = [], []
    real = tmod.SGDTrainer.train_batch

    def spy(self, feed):
        feeds.append(feed)
        loss = real(self, feed)
        losses.append(float(loss))
        return loss

    monkeypatch.setattr(tmod.SGDTrainer, "train_batch", spy)
    with _Lines() as lines:
        assert main(_args("--job=train", "--data_pack")) == 0
    assert any("sequence packing enabled" in m for m in lines)
    assert feeds and all(len(f["words"]) == 5 for f in feeds)
    assert all(f["label"].ndim == 2 for f in feeds)
    assert np.all(np.isfinite(losses))


def test_cli_data_pack_needs_a_data_feeder(tmp_path):
    conf = tmp_path / "conf.py"
    conf.write_text(
        "import sys\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'tests')!r})\n"
        "import torch_textclf_conf as base\n"
        "def get_config():\n"
        "    c = base.get_config()\n"
        "    c['feeder'] = lambda batch: batch\n"
        "    return c\n")
    with pytest.raises(ConfigError, match="DataFeeder"):
        main([f"--config={conf}", "--device=cpu", "--job=train",
              "--data_pack"])


def test_cli_reader_retries_leave_a_checkpointable_source_unwrapped(
        tmp_path, monkeypatch):
    """``--reader_retries`` wraps a plain reader but hands a datapipe
    source to the trainer as it is (its cursor stays visible)."""
    import paddle_tpu_torch.trainer.trainer as tmod
    from paddle_tpu_torch.datapipe import ShardSource, write_shard_set

    out = str(tmp_path / "set")
    import paddle_tpu_torch.data as data

    write_shard_set(out, data.datasets.imdb("train", vocab_size=48, n=12),
                    num_shards=2)
    conf = tmp_path / "conf.py"
    conf.write_text(
        "import sys\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'tests')!r})\n"
        "import torch_textclf_conf as base\n"
        "from paddle_tpu_torch.datapipe import ShardSource\n"
        "def get_config():\n"
        "    c = base.get_config()\n"
        f"    c['reader'] = ShardSource({out!r}, batch_size=6, seed=1)\n"
        "    return c\n")
    seen = []
    real = tmod.SGDTrainer.train

    def spy(self, reader, **kw):
        seen.append(reader)
        return real(self, reader, **kw)

    monkeypatch.setattr(tmod.SGDTrainer, "train", spy)
    with _Lines() as lines:
        assert main([f"--config={conf}", "--device=cpu", "--job=train",
                     "--reader_retries=2"]) == 0
    assert isinstance(seen[0], ShardSource)
    assert any("--reader_retries ignored" in m for m in lines)
