"""Config serialization and deploy bundles — counterpart of
``paddle_tpu/config``.

Serialize a built ``Topology`` to a ModelConfig proto (the port's own codec,
``paddle_tpu_torch/proto``), golden-test its deterministic text form,
rebuild an equivalent Topology in a fresh process, write/load the deploy
bundle (config + parameters in one ``.ptz`` file) that
``InferenceServer`` and ``python -m paddle_tpu_torch serve`` serve, and keep
the compile cache of built kernel libraries (``compile_cache``:
``CompileCacheDir``, ``BundleAotCache``, ``open_cache``, ``warm_bundle``).

Submodules load lazily (PEP 562): ``paddle_tpu_torch.nn`` imports
``config.capture`` at the bottom of its layer modules, and an eager package
``__init__`` would drag ``config_parser``/``deploy`` into that import.

Not ported yet; each raises a ``ConfigError`` naming its ROADMAP.md Queue 1
item: the AOT exports (``export_aot``, ``export_aot_hlo``,
``load_exported``, ``build_aot_host``: StableHLO and a PJRT host in the
reference), item 10.
"""

_EXPORTS = {
    "SerializationError": "config_parser",
    "build_optimizer": "config_parser",
    "build_topology": "config_parser",
    "dump_model_config": "config_parser",
    "dump_trainer_config": "config_parser",
    "parse_protostr": "config_parser",
    "protostr": "config_parser",
    "BundleCorruptError": "deploy",
    "InferenceModel": "deploy",
    "feed_signature": "deploy",
    "load_inference_model": "deploy",
    "merge_model": "deploy",
    "quantize_params": "deploy",
    "configurable": "capture",
    "wrap_module": "capture",
    "BundleAotCache": "compile_cache",
    "CompileCacheDir": "compile_cache",
    "open_cache": "compile_cache",
    "warm_bundle": "compile_cache",
}

#: the reference's exports the port does not have yet -> ROADMAP.md item
_NOT_PORTED = {
    "export_aot": 10, "export_aot_hlo": 10, "load_exported": 10,
    "build_aot_host": 10,
}

__all__ = sorted({**_EXPORTS, **_NOT_PORTED})


def _refusal(name: str, item: int):
    def refuse(*args, **kwargs):
        from paddle_tpu_torch.utils.error import not_ported

        raise not_ported(f"config.{name}", item)

    refuse.__name__ = name
    refuse.__doc__ = (f"Not ported yet: raises a ConfigError naming "
                      f"ROADMAP.md Queue 1 item {item}.")
    return refuse


def __getattr__(name):
    if name in _NOT_PORTED:
        return _refusal(name, _NOT_PORTED[name])
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'paddle_tpu_torch.config' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"paddle_tpu_torch.config.{mod}"),
                   name)


def __dir__():
    return __all__
