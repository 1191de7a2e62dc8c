"""MovieLens recommender — the port's copy of
``demo/recommendation/train.py``.

Trains the reference's full feature network (user id/gender/age/job
embedding tower + movie id/category/title tower, cos_sim*5 regression —
reference demo/recommendation/api_train_v2.py:8-68,
trainer_config.py:30-90) on the 8-slot movielens feed.  ``--simple`` takes
the two-id-tower smoke net instead.

    python -m paddle_tpu_torch.demo.recommendation.train [--device cpu]
"""

import argparse

import paddle_tpu_torch.data as data
import paddle_tpu_torch.models as models
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.param.optimizers import Adam
from paddle_tpu_torch.trainer import SGDTrainer, events


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--emb-dim", type=int, default=32)
    ap.add_argument("--simple", action="store_true",
                    help="two-id-tower smoke net instead of the full "
                         "feature network")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    nn.reset_naming()
    if args.simple:
        cost, pred = models.movielens_net(emb_dim=args.emb_dim, hid_dim=32)
        feeder = data.DataFeeder({"user_id": "int", "movie_id": "int",
                                  "score": "dense"})
        reader = data.batch(
            data.map_readers(lambda r: (r[0], r[1], [r[2]]),
                             data.datasets.movielens("train", n=args.n)),
            args.batch_size)
    else:
        cost, pred = models.movielens_feature_net(emb_dim=args.emb_dim)
        feeder = data.DataFeeder({
            "user_id": "int", "gender_id": "int", "age_id": "int",
            "job_id": "int", "movie_id": "int", "category_id": "sparse_ids",
            "movie_title": "ids_seq", "score": "dense"})
        reader = data.batch(
            data.datasets.movielens_features("train", n=args.n),
            args.batch_size)
    trainer = SGDTrainer(cost, Adam(learning_rate=1e-3), seed=0,
                         device=args.device)

    def on_event(ev):
        if isinstance(ev, events.EndIteration) and ev.batch_id % 4 == 0:
            print(f"pass {ev.pass_id} batch {ev.batch_id} mse {ev.cost:.4f}")

    trainer.train(reader, num_passes=args.passes, event_handler=on_event,
                  feeder=feeder)


if __name__ == "__main__":
    main()
