"""The port's trainers (``okvis2x_tpu_torch/tools/train_*.py``) against the
JAX package's (``tools/train_*.py``): Adam against optax, one step of each
net trainer from the JAX package's initial parameters (converted), the
artifacts each way, the vocabulary trainer's corpus and tree with JAX's
permutation injected (C-H5), and each trainer's `main` on the CPU.

The JAX trainers define their losses inside `main`; the losses below are
copied from them (`tools/train_segmentation.py:113-121`,
`tools/train_stereo.py:134-144`, `tools/train_mvs.py:124-134`).

Tolerances: Adam's parameters after three steps to 1e-6 relative (torch
factors the bias corrections otherwise, float32); a step's loss to 1e-5
relative and each parameter's gradient to 3e-4 of that gradient's largest
entry (float32 convolutions and their transposes summed in another order,
each over all 64x96 pixels of the batch; the MVS net's volume is float64 in
both; the largest gap measured is 1.1e-4, a bias of the MVS feature net after
the Adam step); from an artifact loaded by the
JAX package's `load_params`, the same for the next step, and the
segmentation and stereo nets' outputs to their parity tolerances
(test_torch_segmentation.py, test_torch_models.py); descriptors, trees and
assignments exactly."""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from okvis2x_tpu.frontend import bow as jbow
from okvis2x_tpu.models import mvs_net as jmvs_net
from okvis2x_tpu.models import segmentation as jseg
from okvis2x_tpu.models import stereo_net as jstereo_net
from okvis2x_tpu_torch import convert, optim
from okvis2x_tpu_torch.frontend import bow
from okvis2x_tpu_torch.models import mvs_net, segmentation, stereo_net
from okvis2x_tpu_torch.tools import train_mvs, train_segmentation, train_stereo, train_vocab
from test_torch_vocab import jax_init_indices

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 96
LOSS_RTOL = 1e-5
GRAD_TOL = 3e-4
OUT_TOL = {"segmentation": 5e-5, "stereo": 1e-4}


def test_adam_matches_optax():
    """Three steps of `optim.adam` and of ``optax.adam`` on the same
    gradients, from the same parameters."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (7,), "c": (2, 2, 5)}
    p0 = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(0, 1, s) * 10.0 ** rng.integers(-6, 2)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    tx = optax.adam(1e-3)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    update = jax.jit(tx.update)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = optim.adam(tp.values(), 1e-3)
    for g in grads:
        upd, state = update({k: jnp.asarray(v) for k, v in g.items()}, state)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                   atol=1e-9)
        assert not np.allclose(tp[k].detach().numpy(), p0[k])


# --------------------------------------------------------- the net trainers
def jax_gaussian_nll(pred, sigma, g, valid):
    e = pred - g
    nll = (e * e) / (2.0 * sigma * sigma) + jnp.log(sigma)
    v = valid.astype(jnp.float32)
    return jnp.sum(nll * v) / jnp.maximum(jnp.sum(v), 1.0)


def jax_init(net, *shapes):
    """flax's initial parameters of `net` from ``jax.random.key(0)``, as
    the JAX trainers draw them (`init_*_net`), traced once."""
    return jax.jit(lambda key, *xs: net.init(key, *xs))(jax.random.key(0), *shapes)


def segmentation_case():
    """(JAX net and initial parameters, JAX loss, JAX batch, port net, port
    loss, port batch, port and JAX forward passes) of the segmentation
    trainer at H x W."""
    net = jseg.FastSCNN()
    params = jax_init(net, jnp.zeros((H, W), jnp.float32))
    rng = np.random.default_rng(0)
    ims, cs = train_segmentation.make_pool(train_segmentation.camera(H, W), rng, 4)
    img, lab = train_segmentation.draw_batch(rng, ims, cs, 4)
    wtab = train_segmentation.class_weights()

    def jloss(p, img, lab):
        def one(im, lb):
            ll = jax.nn.log_softmax(net.apply(p, im), axis=-1)
            nll = -jnp.take_along_axis(ll, lb[..., None], axis=-1)[..., 0]
            w = jnp.asarray(wtab)[lb]
            return jnp.sum(nll * w) / jnp.sum(w)

        return jnp.mean(jax.vmap(one)(img, lab))

    batch = (img, lab)
    tbatch = (torch.from_numpy(img), torch.from_numpy(lab), torch.from_numpy(wtab))
    return (net, params, jloss, batch, segmentation.FastSCNN(), train_segmentation.loss, tbatch,
            lambda n, b: n(b[0][0]), lambda p, b: net.apply(p, jnp.asarray(b[0][0])))


def stereo_case():
    net = jstereo_net.StereoNet(max_disp=64)
    params = jax_init(net, jnp.zeros((H, W), jnp.float32), jnp.zeros((H, W), jnp.float32))
    rng = np.random.default_rng(0)
    scenes = train_stereo.make_scenes(rng)
    pool = train_stereo.make_pool(train_stereo.camera(H, W), rng, scenes, 2)
    batch = train_stereo.draw_batch(rng, pool, 4)

    def jloss(p, left, right, gt):
        def one(l, r, g):
            disp, sigma = net.apply(p, l, r)
            return jax_gaussian_nll(disp, sigma, g, (g > 0.5) & (g < net.max_disp - 1))

        return jnp.mean(jax.vmap(one)(left, right, gt))

    return (net, params, jloss, batch, stereo_net.StereoNet(64), train_stereo.loss,
            tuple(map(torch.from_numpy, batch)), lambda n, b: n(b[0][0], b[1][0]),
            lambda p, b: net.apply(p, jnp.asarray(b[0][0]), jnp.asarray(b[1][0])))


def mvs_case():
    net = jmvs_net.MvsNet(n_depths=32)
    params = jax_init(net, jnp.zeros((H, W), jnp.float32), jnp.zeros((2, H, W), jnp.float32),
                      jnp.array([100.0, 100.0, W / 2, H / 2], jnp.float32),
                      jnp.tile(jnp.eye(4, dtype=jnp.float32), (2, 1, 1)))
    rng = np.random.default_rng(0)
    scenes = train_mvs.make_scenes(rng)
    pool = train_mvs.make_pool(train_stereo.camera(H, W), rng, scenes, 2, 2)
    batch = train_mvs.draw_batch(rng, pool, 2, 0.06)
    k = train_mvs.intrinsics(W, H)
    d_lo, d_hi = net.d_min + 0.05, net.d_max - 0.2

    def jloss(p, ref, srcs, T_sr, gt):
        def one(r, s, T, g):
            depth, sigma = net.apply(p, r, s, jnp.asarray(k), T)
            return jax_gaussian_nll(depth, sigma, g, (g > d_lo) & (g < d_hi))

        return jnp.mean(jax.vmap(one)(ref, srcs, T_sr, gt))

    tk = torch.from_numpy(k)
    return (net, params, jloss, batch, mvs_net.MvsNet(), train_mvs.loss,
            tuple(map(torch.from_numpy, batch)),
            lambda n, b: n(b[0][0], b[1][0], tk, b[2][0]),
            lambda p, b: net.apply(p, jnp.asarray(b[0][0]), jnp.asarray(b[1][0]),
                                   jnp.asarray(k), jnp.asarray(b[2][0])))


CASES = {"segmentation": segmentation_case, "stereo": stereo_case, "mvs": mvs_case}
LOADERS = {
    "segmentation": lambda path: jseg.load_params(path),
    "stereo": lambda path: jstereo_net.load_params(path),
    "mvs": lambda path: jmvs_net.load_params(path),
}


def assert_step_equal(loss, grads, ref_loss, ref_grads):
    """A port step's loss and gradients (by parameter name) against JAX's
    (a flax gradient tree)."""
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    ref_grads = convert.stereo_net_params(ref_grads)
    assert grads.keys() == ref_grads.keys()
    for k, g in grads.items():
        r = ref_grads[k].numpy()
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=GRAD_TOL * np.abs(r).max(),
                                   err_msg=k)
    assert any(float(g.abs().max()) > 0 for g in grads.values())


@pytest.mark.parametrize("name", list(CASES))
def test_trainer_step_matches_jax(name, tmp_path):
    """One step from the JAX package's initial parameters on one batch: the
    loss and every gradient as JAX's.  Then the port's Adam step, and the
    artifact it writes, loaded by the JAX package's `load_params`: the next
    step's loss and gradients from it (the JAX net's outputs through the
    loss) as the port's, and, for the segmentation and stereo nets, their
    outputs as the port's."""
    jnet, params, jloss, batch, tnet, tloss, tbatch, tfwd, jfwd = CASES[name]()
    step = jax.jit(jax.value_and_grad(jloss))
    jbatch = tuple(map(jnp.asarray, batch))
    tnet.load_state_dict(convert.stereo_net_params(params))
    assert_step_equal(*optim.loss_and_grads(tnet, tloss, *tbatch), *step(params, *jbatch))

    optim.adam(tnet.parameters(), 1e-3).step()
    path = str(tmp_path / f"{name}.npz")
    convert.save_artifact(path, tnet.state_dict(), probe=1.5)
    jparams, meta = LOADERS[name](path)
    assert meta == {"probe": 1.5}
    assert_step_equal(*optim.loss_and_grads(tnet, tloss, *tbatch), *step(jparams, *jbatch))
    if name == "mvs":  # its forward pass alone is held in test_torch_models.py
        return
    with torch.no_grad():
        got = tfwd(tnet.eval(), tbatch)
    ref = jax.jit(lambda p: jfwd(p, batch))(jparams)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=OUT_TOL[name],
                                   atol=OUT_TOL[name])


@pytest.mark.parametrize("name", ["segmentation", "stereo", "mvs"])
def test_trainer_main_on_cpu(name, tmp_path):
    """`main` at a small size on the CPU: finite losses, and the artifact
    loads through the port's loader with its meta."""
    mod = {"segmentation": train_segmentation, "stereo": train_stereo, "mvs": train_mvs}[name]
    out = str(tmp_path / f"{name}.npz")
    res = mod.main(["--steps", "3", "--pool", "4", "--height", "48", "--width", "64",
                    "--device", "cpu", "--out", out])
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
    if name == "segmentation":
        state, meta = segmentation.load_params(out)
        net = segmentation.FastSCNN()
        net.load_state_dict(state)
        assert set(meta) == set(res["meta"]) and 0 <= meta["iou_sky"] <= 1
    elif name == "stereo":
        net, meta = stereo_net.trained(out, 64, "cpu")
        assert meta["rmse_net"] == res["meta"]["rmse_net"]
    else:
        net, meta = mvs_net.trained(out, "cpu")
        assert (meta["n_src"], meta["n_depths"]) == (2, 32)


# ------------------------------------------------------- the vocabulary
@pytest.fixture(scope="module")
def jax_train_vocab():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        return importlib.import_module("train_vocab")
    finally:
        sys.path.pop(0)


def test_train_vocab_matches_jax(jax_train_vocab, monkeypatch, tmp_path):
    """The corpus of both trainers at 160x120 (the renders, the detector and
    the descriptor) bit for bit; with the JAX permutation injected the tree
    equals JAX's, and the file the port's `main` writes loads in the JAX
    package with the same assignments."""
    ref = jax_train_vocab.collect_descriptors(900, width=160, height=120, verbose=False)
    got = train_vocab.collect_descriptors(900, width=160, height=120, verbose=False)
    np.testing.assert_array_equal(got.numpy(), convert.pack_pm1(ref))
    monkeypatch.setattr(bow, "init_indices", jax_init_indices)
    jv = jbow.train_vocabulary_hier(jnp.asarray(ref), branch=2, leaf=4, iters=3)
    tv = bow.train_vocabulary_hier(got, branch=2, leaf=4, iters=3)
    conv = convert.hier_vocabulary(jv)
    np.testing.assert_array_equal(tv.branches.numpy(), conv.branches.numpy())
    np.testing.assert_array_equal(tv.leaves.numpy(), conv.leaves.numpy())

    monkeypatch.setattr(train_vocab, "collect_descriptors",
                        lambda n, device="cpu": got[:n].to(device))
    out = str(tmp_path / "vocab.npz")
    res = train_vocab.main(["--n", "900", "--branch", "4", "--leaf", "4", "--device", "cpu",
                            "--out", out])
    loaded = jbow.HierVocabulary.load(out)
    ref_words = np.asarray(jbow.assign(jnp.asarray(ref), loaded))
    np.testing.assert_array_equal(res["words"].numpy(), ref_words)
    assert len(np.unique(ref_words)) > 8
