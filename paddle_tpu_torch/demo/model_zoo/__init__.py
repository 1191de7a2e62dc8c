"""The port's copy of ``demo/model_zoo``: ``train_and_publish.py`` writes
the bundle that ``classify.py`` reads (``DEFAULT_BUNDLE`` unless told
otherwise)."""

import os
import tempfile

DEFAULT_BUNDLE = os.path.join(tempfile.gettempdir(),
                              "paddle_tpu_torch_zoo_resnet.ptz")
