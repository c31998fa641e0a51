"""The trainer's kernels under a gradient, on the CPU (their plain
versions): the differentiable splat (K2's forward inside `_SplatBlendFn`,
the plain blend's VJP recomputed one group of tiles at a time) against
`jax.vjp` of the JAX package's splat, the gradient to depth through the
reprojection, and the PixelCNN with train_backend "pallas" (K3's
differentiable entry) against the JAX package's Pallas custom VJP in
interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsynth_tpu.config import SplatConfig as JaxSplatConfig
from pixelsynth_tpu.geometry.projection import (
    homogeneous_to_pixels as jax_h2p, lift_to_cloud as jax_lift,
)
from pixelsynth_tpu.models.lmconv import LMPixelCNN as JaxLMPixelCNN
from pixelsynth_tpu.ops.splat import splat as jax_splat
from pixelsynth_tpu_torch.config import SplatConfig
from pixelsynth_tpu_torch.geometry.projection import homogeneous_to_pixels, lift_to_cloud
from pixelsynth_tpu_torch.models.lmconv import LMPixelCNN
from pixelsynth_tpu_torch.ops import splat as K2
from pixelsynth_tpu_torch.ops.masked_conv_kernel import k3_dtype
from pixelsynth_tpu_torch.ops.orders import orders_and_masks
from pixelsynth_tpu_torch.weights import unflatten_tree

from test_torch_splat import _points
from torch_train_ref import _few_torch_threads  # noqa: F401


def _cfgs(**kw):
    kw = dict(max_points_per_tile=128, tile_size=16, tile_group=2,
              background_smoothing_kernel_size=5, **kw)
    return SplatConfig(**kw), JaxSplatConfig(**kw)


def _assert_grad(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("accumulation", ["alphacomposite", "wsum", "wsumnorm"])
def test_splat_gradients_match_jax_vjp(accumulation):
    """d points and d feats of the splatted image for one cotangent, to
    1e-4 of their scale (float32 both sides, sums in other orders); the
    depth column gets none, in both."""
    pts, feats, valid = _points(N=160, seed=2)
    cfg, jcfg = _cfgs(accumulation=accumulation)
    cot = np.random.default_rng(3).normal(size=(2, 32, 32, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda p, f: jax_splat(p, f, jnp.asarray(valid), W=32, cfg=jcfg)[0],
                     jnp.asarray(pts), jnp.asarray(feats))
    want_p, want_f = vjp(jnp.asarray(cot))
    p = torch.tensor(pts, requires_grad=True)
    f = torch.tensor(feats, requires_grad=True)
    out, _ = K2.splat(p, f, torch.as_tensor(valid), W=32, cfg=cfg)
    gp, gf = torch.autograd.grad(out, (p, f), torch.as_tensor(cot))
    assert float(np.abs(np.asarray(want_p)).max()) > 0
    _assert_grad(gp.numpy(), want_p, 1e-4)
    _assert_grad(gf.numpy(), want_f, 1e-4)
    assert float(gp[..., 2].abs().max()) == 0.0


def test_groupwise_vjp_equals_direct_autograd():
    """blend_slots_vjp (one group of tile_group tiles at a time) against
    autograd through blend_slots_plain over every tile at once: the same
    computation."""
    pts, feats, valid = _points(N=200, seed=4)
    cfg, _ = _cfgs()
    pt, ft = torch.tensor(pts), torch.tensor(feats)
    idx, svld = K2._bin_points_batched(pt, torch.as_tensor(valid), 32, cfg)
    cot = torch.as_tensor(np.random.default_rng(5).normal(size=(2, 32, 32, 3)),
                          dtype=torch.float32)
    dp, df = K2.blend_slots_vjp(cot, pt, ft, idx, svld, 32, cfg)
    p, f = pt.clone().requires_grad_(True), ft.clone().requires_grad_(True)
    out, _ = K2.blend_slots_plain(p, f, idx, svld, 32, cfg)
    wp, wf = torch.autograd.grad(out, (p, f), cot)
    torch.testing.assert_close(dp, wp, rtol=1e-5, atol=1e-6 * float(wp.abs().max()))
    torch.testing.assert_close(df, wf, rtol=1e-5, atol=1e-6 * float(wf.abs().max()))


def test_k2_under_a_gradient_is_the_autograd_function():
    """blend_slots with points that require grad goes through
    _SplatBlendFn (its forward: the plain version on the CPU, counted
    once), the covered mask has no gradient, and the kernel's launcher
    refuses a gradient."""
    pts, feats, valid = _points(N=100, seed=6)
    cfg, _ = _cfgs()
    p = torch.tensor(pts, requires_grad=True)
    idx, svld = K2._bin_points_batched(p.detach(), torch.as_tensor(valid), 32, cfg)
    before = K2.PLAIN_CALLS["splat_blend"]
    out, cov = K2.blend_slots(p, torch.as_tensor(feats), idx, svld, 32, cfg)
    assert K2.PLAIN_CALLS["splat_blend"] == before + 1
    assert type(out.grad_fn).__name__ == "_SplatBlendFnBackward"
    assert cov.dtype == torch.bool and not cov.requires_grad
    with torch.no_grad():
        plain, _ = K2.blend_slots_plain(p, torch.as_tensor(feats), idx, svld, 32, cfg)
    torch.testing.assert_close(out.detach(), plain, rtol=0, atol=0)
    with pytest.raises(ValueError, match="no gradient"):
        K2.blend_slots_kernel(p, torch.as_tensor(feats), idx, svld, 32, cfg)


def test_depth_gradient_through_reprojection_and_splat_matches_jax():
    """A camera that moves as well as turns: the splatted features depend
    on depth through lift_to_cloud and homogeneous_to_pixels, and the
    gradient to depth matches the JAX package's (1e-4 of its scale)."""
    rng = np.random.default_rng(7)
    W, B = 32, 2
    depth = rng.uniform(1.0, 4.0, (B, W, W)).astype(np.float32)
    feats = rng.normal(size=(B, W * W, 3)).astype(np.float32)
    I = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    RT = I.copy()
    c, s = np.cos(0.1), np.sin(0.1)
    RT[:, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    RT[:, :3, 3] = [0.15, -0.05, 0.1]
    cot = rng.normal(size=(B, W, W, 3)).astype(np.float32)
    cfg, jcfg = _cfgs()

    def jfn(d):
        pts, valid = jax_h2p(jax_lift(d, I, I, I, RT, W), W)
        return jax_splat(pts, jnp.asarray(feats), valid, W=W, cfg=jcfg)[0]

    _, vjp = jax.vjp(jfn, jnp.asarray(depth))
    (want,) = vjp(jnp.asarray(cot))
    d = torch.tensor(depth, requires_grad=True)
    t = [torch.as_tensor(a) for a in (I, RT)]
    pts, valid = homogeneous_to_pixels(lift_to_cloud(d, t[0], t[0], t[0], t[1], W), W)
    out, _ = K2.splat(pts, torch.as_tensor(feats), valid, W=W, cfg=cfg)
    (g,) = torch.autograd.grad(out, d, torch.as_tensor(cot))
    assert float(np.abs(np.asarray(want)).max()) > 0
    _assert_grad(g.numpy(), want, 1e-4)


def test_pixelcnn_pallas_route_matches_jax_pallas_vjp():
    """train_backend "pallas": the port's PixelCNN with every masked conv
    through K3's differentiable entry (its plain version here, bf16
    operands) against the JAX LMPixelCNN on its Pallas custom VJP in
    interpret mode, on an 8x8 grid with the one-hot first layer (Cin =
    513, which K3 serves by its f32 kernel on bf16-rounded operands):
    logits and every parameter's gradient to 2e-2 of their scale (the bound
    of tests/test_lmconv_fast.py:67 for bf16 against bf16)."""
    # at the full width's 32x32 grid: the one-hot layer on the f32 kernel,
    # the others on the bf16 kernel (8x8 is below the bf16 kernel's tiles)
    assert k3_dtype(1024, 513, 80, "bfloat16") == "float32"
    assert k3_dtype(1024, 160, 80, "bfloat16") == "bfloat16"
    rng = np.random.default_rng(8)
    B, S, Fc, NC = 2, 8, 16, 512
    kw = dict(nr_resnet=1, nr_filters=Fc, input_channels=NC, num_classes=NC)
    jm = JaxLMPixelCNN(**kw, compute_dtype="bfloat16", backend="pallas")
    codes = rng.integers(0, NC, (B, S, S))
    dist = rng.normal(size=(B, S, S)).astype(np.float32)
    _, masks = orders_and_masks(torch.as_tensor(dist), 3, 2)
    masks = masks.numpy()
    oh = np.eye(NC, dtype=np.float32)[codes]
    m = LMPixelCNN(**kw, compute_dtype="bfloat16", backend="pallas")
    with torch.no_grad():
        m.reset(torch.Generator().manual_seed(0))
    m.requires_grad_(True)
    from pixelsynth_tpu_torch.models.lmconv import flax_named_params

    params = unflatten_tree({k: jnp.asarray(v.numpy())
                             for k, v in flax_named_params(m).items()})
    cot = rng.normal(size=(B, S, S, NC)).astype(np.float32)

    def jfn(p):
        return jm.apply({"params": p}, jnp.asarray(oh), *(jnp.asarray(masks[:, i])
                                                          for i in range(3)), train=True)

    jout, vjp = jax.vjp(jfn, params)
    (jg,) = vjp(jnp.asarray(cot))
    m.train()
    out = m(torch.as_tensor(oh), *(torch.as_tensor(masks[:, i]) for i in range(3)))
    _assert_grad(out.detach().numpy(), jout, 2e-2)
    named = list(m.named_parameters())
    grads = torch.autograd.grad(out, [p for _, p in named], torch.as_tensor(cot))
    want = {k: np.asarray(v) for k, v in _flat_params(jg).items()}
    for (name, _), g in zip(named, grads):
        key = name.replace(".", "/")
        w = want[key.replace("/weight", "/kernel") if "Dense" in key and key.endswith("weight") else key]
        got = g.numpy().T if "Dense" in name and name.endswith("weight") else g.numpy()
        _assert_grad(got, w, 2e-2)


def _flat_params(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_params(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}
