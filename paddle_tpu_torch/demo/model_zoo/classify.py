"""Model-zoo consumer — the port's copy of ``demo/model_zoo/classify.py``
(reference demo/model_zoo/resnet/classify.py: an ImageClassifier with
--job=classify | --job=extract reading a published train_conf +
model_dir; classify.py:22).

Loads the published bundle with no model code (``load_inference_model``,
the py_paddle swig inference analog) and either classifies images or
extracts the pre-logits feature layer named in the bundle's manifest.

    python -m paddle_tpu_torch.demo.model_zoo.classify --model zoo.ptz \
        --job classify|extract [--device cpu]
"""

import argparse

import numpy as np

from paddle_tpu_torch.config import load_inference_model
from paddle_tpu_torch.demo.model_zoo import DEFAULT_BUNDLE


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=DEFAULT_BUNDLE)
    ap.add_argument("--job", choices=["classify", "extract"],
                    default="classify")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model = load_inference_model(args.model, device=args.device)
    print("loaded", model.manifest.get("name"),
          "inputs", model.input_names, "meta task",
          model.manifest.get("task"))

    rng = np.random.RandomState(0)
    imgs = rng.rand(args.batch_size, 32, 32, 3).astype(np.float32)
    feed = {"pixel": imgs, "label": np.zeros((args.batch_size, 1), np.int32)}

    if args.job == "classify":
        out = model.infer(feed, outputs=["logits"])["logits"]
        probs = np.exp(out - out.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        pred = probs.argmax(-1)
        for i in range(args.batch_size):
            print(f"image {i}: class {pred[i]} prob {probs[i, pred[i]]:.3f}")
    else:
        layer = model.manifest.get("feature_layer", "gap")
        feats = model.infer(feed, outputs=[layer])[layer]
        feats = feats.reshape(args.batch_size, -1)
        print(f"extracted features from {layer!r}: shape {feats.shape}, "
              f"norm {np.linalg.norm(feats, axis=1).mean():.3f}")


if __name__ == "__main__":
    main()
