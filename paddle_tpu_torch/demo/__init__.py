"""The port's copies of the reference's ``demo/`` scripts, one package per
demo (``README.md`` maps each to its reference).  Each runs from the root
of a checkout as ``python -m paddle_tpu_torch.demo.<name>.train`` with the
reference's arguments and defaults, plus ``--device`` (``cuda`` by
default; ``cpu`` runs the kernels' plain versions)."""
