"""Training helpers of the port's trainers (``okvis2x_tpu_torch/tools/
train_*.py``): the optimiser and the initialisation of the JAX package's
trainers, and the artifact they write.

  * `adam` is ``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8 added to the
    square root of the bias-corrected second moment, eps_root 0, no weight
    decay; ``torch.optim.Adam`` computes the same update (one tensor at a
    time, ``foreach=False``; its bias corrections are factored otherwise, so
    the two agree to float32 rounding).
  * `train` runs the steps: the loss and its gradients with TF32 off in the
    forward and the backward pass (the JAX package trains at ``highest``
    precision), then the Adam update.
  * `flax_init_` draws every convolution and dense kernel from flax's default
    ``lecun_normal`` (a normal truncated to two standard deviations, scaled
    to variance 1 / fan_in) and zeroes the biases, from a seeded
    ``torch.Generator`` on the CPU.  The JAX trainers draw from
    ``jax.random.key(0)``, whose stream torch cannot reproduce (C-H16 in
    ROADMAP.md): the distributions are flax's, the draws are not.
"""

from __future__ import annotations

import math
import sys
import time
from pathlib import Path

import torch
from torch import nn

from okvis2x_tpu_torch.models import stereo_net

# flax's truncated normal keeps [-2, 2]; this is its standard deviation
TRUNC_STD = 0.87962566103423978
# the trainers' artifacts; the JAX trainers write into okvis2x_tpu/resources/
ARTIFACTS = Path(__file__).resolve().parents[1] / "build" / "okvis2x_tpu_torch" / "artifacts"


def adam(params, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)`` over `params`."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, foreach=False)


@torch.no_grad()
def flax_init_(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's default initialisation of every ``Conv2d`` and ``Linear`` of
    `net` (on the CPU), drawn in module order from `generator`."""
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()  # in / groups x kh x kw, or in
            std = math.sqrt(1.0 / fan_in) / TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            nn.init.zeros_(m.bias)
    return net


def train(net: nn.Module, loss_fn, next_batch, steps: int, lr: float):
    """`steps` Adam steps on ``loss_fn(net, *next_batch())``; the loss is
    printed every 50 steps to stderr, as the JAX trainers print it.
    Returns (the loss of every step, the seconds of every step, its batch
    included)."""
    opt = adam(net.parameters(), lr)
    losses, secs = [], []
    t_start = time.perf_counter()
    for it in range(steps):
        t0 = time.perf_counter()
        batch = next_batch()
        with stereo_net.full_precision():
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(net, *batch)
            loss.backward()
            opt.step()
        losses.append(float(loss.detach()))  # waits for the step
        secs.append(time.perf_counter() - t0)
        if it % 50 == 0:
            print(f"step {it}  loss {losses[-1]:.4f}  ({time.perf_counter() - t_start:.0f}s)",
                  file=sys.stderr, flush=True)
    return losses, secs


def loss_and_grads(net: nn.Module, loss_fn, *batch):
    """One step's loss and the gradient of every parameter by name, TF32 off
    (what the tests and the card's check hold against a reference)."""
    net.zero_grad(set_to_none=True)
    with stereo_net.full_precision():
        loss = loss_fn(net, *batch)
        loss.backward()
    return loss.detach(), {k: p.grad.detach().clone() for k, p in net.named_parameters()}
