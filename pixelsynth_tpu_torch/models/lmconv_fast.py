"""Per-layer kernel engine for the locally-masked PixelCNN (port of
pixelsynth_tpu/models/lmconv_fast.py).

The same forward as `LMPixelCNN` from the same parameters, composed of:
  * first layer: the embedding gather over (codes, filled)
    (ops/masked_conv.locally_masked_embed) + PONO;
  * every gated resnet: ONE launch of kernel K4
    (ops/gated_resnet_kernel.py): two masked convs, PONOs, skip nin and
    gate;
  * the dilated stream convs: kernel K3 (ops/masked_conv_kernel.py) + PONO;
  * the output nin: one matmul (outside any kernel, as in the JAX package).
On CPU tensors the wrappers take their plain versions.  Parameters are the
flat Flax-named dict of `models.lmconv.flax_named_params` (or of a stitched
checkpoint's `pixelcnn/params`).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from pixelsynth_tpu_torch.models.layers import pono
from pixelsynth_tpu_torch.ops.conv_pack import prepare_taps
from pixelsynth_tpu_torch.ops.gated_resnet_kernel import gated_resnet_kernel
from pixelsynth_tpu_torch.ops.masked_conv import locally_masked_embed
from pixelsynth_tpu_torch.ops.masked_conv_kernel import (
    locally_masked_conv2d_kernel, prepare_mask, raw_mask,
)


def cast_conv_weights(params: Dict[str, torch.Tensor],
                      compute_dtype: str) -> Dict[str, torch.Tensor]:
    """A copy of `params` whose kernel operands (the masked-conv taps past
    the first layer and the skip nins) are already what the kernels read,
    so a sampling loop does not cast or lay them out at every launch: on
    the card `PackedTaps` (bf16, the kernels' shared-memory image), on the
    CPU the bf16 cast the plain versions round to."""
    if compute_dtype != "bfloat16":
        return dict(params)
    width = params["LMConv_0/bias"].shape[0]
    out = {}
    for name, p in params.items():
        operand = ((name.endswith("/weight") and name != "LMConv_0/weight")
                   or (name.startswith("GatedResnet") and name.endswith("/kernel")))
        if operand and p.is_cuda:
            out[name] = prepare_taps(p if p.dim() == 3 else p[None], width)
        else:
            out[name] = p.to(torch.bfloat16) if operand else p
    return out


def pixelcnn_forward_fast(params: Dict[str, torch.Tensor], codes, filled,
                          mask_init, mask_undilated, mask_dilated, *,
                          nr_resnet: int = 2, max_dilation: int = 2,
                          num_classes: int = 512,
                          compute_dtype: str = "bfloat16") -> torch.Tensor:
    """codes/filled (B, H, W); masks (B, k^2, H*W) or PreparedMasks.
    Returns logits (B, H, W, num_classes)."""

    def gated(name, u, a=None):
        w_skip = params.get(f"{name}/Nin_0/Dense_0/kernel")
        b_skip = params.get(f"{name}/Nin_0/Dense_0/bias")
        return gated_resnet_kernel(
            u, a, mask_undilated,
            params[f"{name}/LMConv_0/weight"], params[f"{name}/LMConv_0/bias"],
            w_skip, b_skip,
            params[f"{name}/LMConv_1/weight"], params[f"{name}/LMConv_1/bias"],
            compute_dtype=compute_dtype)

    def dconv(name, u):
        return locally_masked_conv2d_kernel(
            u, mask_dilated, params[f"{name}/weight"], params[f"{name}/bias"],
            dilation=max_dilation, compute_dtype=compute_dtype)

    # first layer (type-A mask) + pono
    u0 = locally_masked_embed(codes, filled, raw_mask(mask_init),
                              params["LMConv_0/weight"].float(),
                              params["LMConv_0/bias"], num_classes=num_classes)
    u_list = [pono(u0)]

    g = 0       # gated resnet counter
    d = 1       # dilated LMConv counter (LMConv_0 is u_init)
    ### UP PASS
    for _ in range(2):
        for _ in range(nr_resnet):
            u_list.append(gated(f"GatedResnet_{g}", u_list[-1]))
            g += 1
        u_list.append(pono(dconv(f"LMConv_{d}", u_list[-1])))
        d += 1
    for _ in range(nr_resnet):
        u_list.append(gated(f"GatedResnet_{g}", u_list[-1]))
        g += 1

    ### DOWN PASS
    down_nr = [nr_resnet, nr_resnet + 1, nr_resnet + 1]
    u = u_list.pop()
    for i in range(2):
        for _ in range(down_nr[i]):
            u = gated(f"GatedResnet_{g}", u, u_list.pop())
            g += 1
        u = pono(dconv(f"LMConv_{d}", u))
        d += 1
    for _ in range(down_nr[2]):
        u = gated(f"GatedResnet_{g}", u, u_list.pop())
        g += 1
    assert not u_list

    return (torch.matmul(F.elu(u), params["Nin_0/Dense_0/kernel"].float())
            + params["Nin_0/Dense_0/bias"])


def fast_logits_fn(params: Dict[str, torch.Tensor], masks: torch.Tensor,
                   model) -> Callable:
    """Bind masks (B, 3, k2, HW) -> fn(codes, filled) -> logits.  `model` is
    the LMPixelCNN the parameters belong to (its nr_resnet, max_dilation,
    num_classes and compute_dtype).  The masks are laid out for the kernels
    and the weights cast once, here, outside the sampling loop."""
    cdt = model.compute_dtype or "bfloat16"
    params = cast_conv_weights(params, cdt)
    m_init, m_und, m_dil = masks[:, 0], masks[:, 1], masks[:, 2]
    if masks.is_cuda:
        m_und, m_dil = prepare_mask(m_und), prepare_mask(m_dil)

    def fn(codes, filled):
        return pixelcnn_forward_fast(
            params, codes, filled, m_init, m_und, m_dil,
            nr_resnet=model.nr_resnet, max_dilation=model.max_dilation,
            num_classes=model.num_classes, compute_dtype=cdt)

    return fn
