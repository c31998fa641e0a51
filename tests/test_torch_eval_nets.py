"""The port's eval networks and metric arithmetic against the JAX package's.

Each test writes a seeded npz in torchvision's layout (the keys and shapes
of the port's modules, which carry torchvision's names).  The JAX package's
loaders and the port's both read it, so the two networks hold the same
weights without Flax's init of the InceptionV3.  Images are made from a
numpy seed; on the JAX side the networks run as its own tests run them on
the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsynth_tpu.eval import inception as jinc
from pixelsynth_tpu.eval import metrics as jmet
from pixelsynth_tpu_torch.eval import inception as tinc
from pixelsynth_tpu_torch.eval import metrics as tmet
from pixelsynth_tpu_torch.weights import eval_net_state_dict
from torch_threads import _few_torch_threads  # noqa: F401

JAX_LOADERS = {"vgg16": jmet.load_torch_vgg16, "alex": jmet.load_torch_alexnet,
               "squeeze": jmet.load_torch_squeezenet}
PORT_LOADERS = {"vgg16": tmet.load_torch_vgg16, "alex": tmet.load_torch_alexnet,
                "squeeze": tmet.load_torch_squeezenet}


def write_torchvision_npz(module, path, seed):
    """Random weights for every entry of `module`'s state dict, by its
    torchvision names: He-normal convs, BatchNorm statistics and affine
    terms near (but not at) the identity."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in module.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            continue
        if len(shape) == 4:
            a = rng.normal(size=shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif k.endswith("bn.weight"):
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = rng.normal(size=shape) * 0.1
        out[k] = a.astype(np.float32)
    np.savez(path, **out)
    return path


def _images(seed, B, H, W=None):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (B, H, W or H, 3)).astype(np.float32)


@pytest.mark.parametrize("net,size", [("vgg16", 32), ("alex", 64), ("squeeze", 48),
                                      ("squeeze", 64)])
def test_percsim_matches_jax(tmp_path, net, size):
    path = write_torchvision_npz(tmet.PNET_NETS[net](), str(tmp_path / f"{net}.npz"), 1)
    variables = JAX_LOADERS[net](path)
    a, b = _images(2, 3, size), _images(3, 3, size)
    want = np.asarray(jmet.PercSim(variables=variables, net=net)(a, b))
    got = tmet.PercSim(net, PORT_LOADERS[net](path), device="cpu")(a, b)
    assert got.shape == (3,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # the bridge from the JAX variables gives the npz's state dict exactly
    bridged = eval_net_state_dict(net, variables)
    for k, v in PORT_LOADERS[net](path).items():
        assert torch.equal(bridged[k], v), k


@pytest.mark.parametrize("with_lin", [False, True])
def test_lpips_matches_jax(tmp_path, with_lin):
    path = write_torchvision_npz(tmet.VGG16Features(), str(tmp_path / "vgg16.npz"), 4)
    rng = np.random.default_rng(5)
    lins = ([rng.uniform(0, 0.2, c).astype(np.float32) for c in (64, 128, 256, 512, 512)]
            if with_lin else None)
    a, b = _images(6, 2, 40), _images(7, 2, 40)
    want = np.asarray(jmet.LPIPS(variables=jmet.load_torch_vgg16(path), lin_weights=lins)(a, b))
    got = tmet.LPIPS(tmet.load_torch_vgg16(path), lins, device="cpu")(a, b)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_lpips_lin_loader_matches_jax(tmp_path):
    rng = np.random.default_rng(8)
    chans = [64, 128, 256, 512, 512]
    for fmt in ("lin{}.model.1.weight", "lins.{}.model.1.weight"):
        raw = {fmt.format(i): rng.random((1, c, 1, 1)).astype(np.float32)
               for i, c in enumerate(chans)}
        path = str(tmp_path / "lpips.npz")
        np.savez(path, **raw)
        got, want = tmet.load_lpips_lin_weights(path), jmet.load_lpips_lin_weights(path)
        assert [w.shape for w in got] == [w.shape for w in want] == [(c,) for c in chans]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_random_init_is_seeded_and_finite():
    a, b = _images(9, 2, 32), _images(10, 2, 32)
    p1 = tmet.PercSim("vgg16", device="cpu", gen=torch.Generator().manual_seed(3))(a, b)
    p2 = tmet.PercSim("vgg16", device="cpu", gen=torch.Generator().manual_seed(3))(a, b)
    np.testing.assert_array_equal(p1, p2)
    assert np.isfinite(p1).all() and (p1 > 0).all()
    assert (tmet.PercSim("vgg16", device="cpu")(a, a) < 1e-5).all()


def test_inception_features_match_jax(tmp_path):
    """InceptionV3Features at 75x75 (the smallest input the network takes),
    the npz through both loaders, to 1e-4 of the features' scale; and the
    bridge from the JAX variables."""
    path = write_torchvision_npz(tinc.InceptionV3Features(), str(tmp_path / "inc.npz"), 11)
    variables = jinc.load_torch_inception(path)
    x = np.random.default_rng(12).uniform(-1, 1, (2, 75, 75, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jinc.InceptionV3Features().apply)(variables, jnp.asarray(x)))
    sd = tinc.load_torch_inception(path)
    net = tmet.build_net(tinc.InceptionV3Features(), sd, "cpu", None)
    with torch.no_grad():
        got = net(torch.as_tensor(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 2048)
    scale = np.abs(want).max()
    assert scale > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-4 * scale)
    bridged = eval_net_state_dict("inception", variables)
    assert sorted(bridged) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(bridged[k], v), k


@pytest.mark.parametrize("size", [64, 320])
def test_preprocess_for_inception_matches_jax(size):
    """jax.image.resize's bilinear, up from 64 and down (antialiased) from
    320."""
    img = _images(13, 2, size)
    want = np.asarray(jinc.preprocess_for_inception(jnp.asarray(img)))
    got = tinc.preprocess_for_inception(img).numpy()
    assert got.shape == want.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_fid_feature_fn_batches_and_scores_identical_sets_at_zero():
    fn = tinc.make_fid_feature_fn(device="cpu", gen=torch.Generator().manual_seed(1),
                                  batch=2)
    imgs = _images(14, 3, 32)
    feats = fn(imgs)
    assert feats.shape == (3, 2048) and feats.dtype == np.float32
    np.testing.assert_allclose(fn(imgs[1:2]), feats[1:2], rtol=1e-5, atol=1e-6)


def test_fid_is_and_tails_match_jax():
    rng = np.random.default_rng(15)
    f1 = rng.normal(size=(40, 16))
    f2 = rng.normal(size=(40, 16)) * 1.3 + 0.2
    mu1, s1 = tmet.feature_stats(f1)
    mu2, s2 = tmet.feature_stats(f2)
    jmu1, js1 = jmet.feature_stats(f1)
    np.testing.assert_array_equal(mu1, jmu1)
    np.testing.assert_array_equal(s1, js1)
    got = tmet.fid_from_stats(mu1, s1, mu2, s2)
    want = jmet.fid_from_stats(mu1, s1, mu2, s2)
    assert got > 0 and abs(got - want) <= 1e-6 * abs(want)
    assert abs(tmet.fid_from_stats(mu1, s1, mu1, s1)) < 1e-6
    logits = rng.normal(size=(30, 10)) * 2
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    for g, w in zip(tmet.inception_score(probs, splits=3),
                    jmet.inception_score(probs, splits=3)):
        assert abs(g - w) <= 1e-6 * abs(w)
    psnrs, percs, ssims = rng.uniform(10, 30, 50), rng.uniform(1, 4, 50), rng.uniform(0, 1, 50)
    assert tmet.tail_rates(psnrs, percs, ssims) == jmet.tail_rates(psnrs, percs, ssims)
