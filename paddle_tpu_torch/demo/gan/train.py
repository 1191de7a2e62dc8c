"""GAN on 2-D synthetic data — the port's copy of ``demo/gan/train.py``
(reference demo/gan/gan_trainer.py trains a generator and a discriminator
as two alternating networks).

Two Topologies (G, D) with their own parameters; each alternating update
is ``torch.autograd.grad`` of its loss and an Adam step of its network's
parameters.

    python -m paddle_tpu_torch.demo.gan.train [--device cpu]
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.param.optimizers import Adam


def build(noise_dim, hid, device):
    nn.reset_naming()
    z = nn.data("z", size=noise_dim)
    gh = nn.fc(z, hid, act="relu", name="g_h1")
    gh = nn.fc(gh, hid, act="relu", name="g_h2")
    fake = nn.fc(gh, 2, act="linear", name="g_out")
    g_topo = nn.Topology(fake, device=device)

    x = nn.data("x", size=2)
    dh = nn.fc(x, hid, act="relu", name="d_h1")
    dh = nn.fc(dh, hid, act="relu", name="d_h2")
    dlogit = nn.fc(dh, 1, act="linear", name="d_out")
    d_topo = nn.Topology(dlogit, device=device)
    return g_topo, fake.name, d_topo, dlogit.name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--noise-dim", type=int, default=8)
    ap.add_argument("--hid", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    g_topo, g_out, d_topo, d_out = build(args.noise_dim, args.hid,
                                         args.device)
    dev = g_topo.device
    g_params = {k: v.requires_grad_() for k, v in g_topo.init(1)[0].items()}
    d_params = {k: v.requires_grad_() for k, v in d_topo.init(2)[0].items()}
    g_opt, d_opt = Adam(learning_rate=1e-3), Adam(learning_rate=1e-3)
    g_state, d_state = g_opt.init_state(g_params), d_opt.init_state(d_params)

    def d_logit(dp, x):
        outs, _ = d_topo.apply(dp, {}, {"x": x})
        return outs[d_out].value[:, 0]

    def gen(gp, z):
        outs, _ = g_topo.apply(gp, {}, {"z": z})
        return outs[g_out].value

    def bce(logit, is_real):
        y = torch.full_like(logit, 1.0 if is_real else 0.0)
        return F.binary_cross_entropy_with_logits(logit, y)

    def step(opt, params, state, loss):
        grads = torch.autograd.grad(loss, list(params.values()))
        opt.update(params, dict(zip(params, grads)), state)
        return loss.item()

    rng = np.random.RandomState(0)

    def real_batch():
        # a ring of radius 2: the target distribution
        theta = rng.rand(args.batch_size) * 2 * np.pi
        r = 2.0 + 0.1 * rng.randn(args.batch_size)
        return torch.from_numpy(np.stack(
            [r * np.cos(theta), r * np.sin(theta)], 1).astype("float32")
        ).to(dev)

    def noise(n):
        return torch.from_numpy(
            rng.randn(n, args.noise_dim).astype("float32")).to(dev)

    for i in range(args.steps):
        z = noise(args.batch_size)
        with torch.no_grad():
            fake = gen(g_params, z)
        dl = step(d_opt, d_params, d_state,
                  bce(d_logit(d_params, real_batch()), True)
                  + bce(d_logit(d_params, fake), False))
        z = noise(args.batch_size)
        gl = step(g_opt, g_params, g_state,
                  bce(d_logit(d_params, gen(g_params, z)), True))
        if i % 50 == 0:
            print(f"step {i} d_loss {dl:.4f} g_loss {gl:.4f}")

    # how close the generated samples are to the target ring's radius
    with torch.no_grad():
        samples = gen(g_params, noise(512)).float().cpu().numpy()
    radii = np.linalg.norm(samples, axis=1)
    print(f"generated radius mean {radii.mean():.2f} (target 2.0) "
          f"std {radii.std():.2f}")


if __name__ == "__main__":
    main()
