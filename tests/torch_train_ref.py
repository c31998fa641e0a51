"""Helpers of the trainer's parity tests (tests/test_torch_train_*.py):
running the JAX package's training code in float64 as the reference.

On the CPU the JAX package's float32 training graph sits far from its own
float64 value: through the VGG19's sixteen convolutions ~1% of the
perceptual gradient's scale, through the refinement decoder's train-mode
BatchNorms ~3e-3 of its gradients, where the port's float32 stays within
~1e-6 of float64 (measured on the configs of these tests).  So gradients
and collection updates are compared with both sides in float64: JAX under
`jax.enable_x64`, the port's modules `.double()`, but for the PixelCNN,
which stays float32 there and is held to float32 bounds."""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np

from pixelsynth_tpu.models import losses as jax_losses
from torch_threads import _few_torch_threads  # noqa: F401


def to64(tree):
    """Floating leaves of a tree as float64 JAX arrays (under x64)."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64))
        if np.issubdtype(np.asarray(a).dtype, np.floating) else jnp.asarray(a), tree)


_ssim = jax_losses.ssim


def _ssim32(pred, gt, window_size=11):
    # the JAX ssim builds its window in the default float type and casts
    # its inputs to float32, which lax.conv refuses under x64: evaluate the
    # metric (no part of any loss) in float32
    with jax.enable_x64(False):
        return _ssim(pred.astype(jnp.float32), gt.astype(jnp.float32), window_size)


@contextlib.contextmanager
def jax_float64():
    """JAX in float64, with the float32 ssim metric."""
    with jax.enable_x64(True), mock.patch.object(jax_losses, "ssim", _ssim32):
        yield


def flat(tree, prefix=""):
    """{"a/b/c": leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def tiny_variables(jps, cfg, seed=0):
    """A Flax variable tree of every network of the trainer for `jps` (a
    JAX PixelSynth) without compiling its init: shapes by jax.eval_shape,
    values from a numpy seed (test_torch_models._fill, spectral vectors
    converged), the PixelCNN the port's seeded init."""
    import torch

    from pixelsynth_tpu_torch.pipeline import random_pixelcnn_params
    from pixelsynth_tpu_torch.weights import unflatten_tree
    from test_torch_models import _converge_spectral, _fill

    shapes = jax.eval_shape(lambda: jps.init_variables(jax.random.PRNGKey(0),
                                                       on_cpu=False))
    variables = _converge_spectral(_fill(shapes, np.random.default_rng(seed)))
    pc = random_pixelcnn_params(cfg, torch.Generator().manual_seed(seed))
    variables["pixelcnn"] = {"params": unflatten_tree(
        {k: jnp.asarray(v.numpy()) for k, v in pc.items()})}
    return variables


def grads_in_port_layout(cfg, variables, grads, tree):
    """The JAX gradient tree of `tree` as the port's {parameter name:
    array}: loaded as if it were the parameters through the bridge, into a
    float64 module (so float64 leaves keep every bit)."""
    import torch

    from pixelsynth_tpu_torch.pipeline import build_modules, build_pixelcnn
    from pixelsynth_tpu_torch.weights import merge_collections

    m = (build_pixelcnn(cfg, trainable=True) if tree == "pixelcnn"
         else build_modules(cfg, trainable=True)[tree]).double()
    with torch.no_grad():
        m.load_flax(merge_collections({**variables[tree], "params": grads}))
    return {n: p.detach().numpy() for n, p in m.named_parameters()}
