"""Locally-masked PixelCNN as `nn.Module`s, NHWC (port of
pixelsynth_tpu/models/lmconv.py).

The module path of the PixelCNN: every convolution is one locally masked
conv taking the per-image mask triple (A-mask for the first layer, B-mask
undilated for the resnet streams, B-mask dilated for the dilation streams)
in the compact (B, k*k, H*W) layout.  `backend="xla"` runs the plain,
differentiable `locally_masked_conv2d`; `backend="pallas"` (the name the
configs carry) runs kernel K3, one launch per conv: through its
differentiable entry where a gradient is wanted, else (under
`torch.no_grad()`, or when nothing requires grad) straight through the
kernel's wrapper.  Children carry Flax's names, so the Flax `pixelcnn` tree loads
by name (`load_flax`) and `flax_named_params` hands the same parameters to
the fused forward (K1) and the per-layer kernel engine
(models/lmconv_fast.py).

Masks may be given as `PreparedMask`s (ops/masked_conv_kernel.py), so a
sampling loop lays them out for the kernel once.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pixelsynth_tpu_torch.models.layers import (
    FlaxNamed, Nin, _t, concat_elu, order_rescale, pono,
)
from pixelsynth_tpu_torch.ops.masked_conv import (
    locally_masked_conv2d, locally_masked_embed, mask_rows,
)
from pixelsynth_tpu_torch.ops.conv_pack import prepare_taps
from pixelsynth_tpu_torch.ops.masked_conv_kernel import (
    k3_layer_conv, kernel_width, locally_masked_conv2d_kernel_vjp, raw_mask,
)
from pixelsynth_tpu_torch.parallel.mesh import draw_rows

BACKENDS = ("xla", "pallas")


class LMConv(FlaxNamed):
    """One locally masked conv layer; weight (k*k, Cin, Cout).

    With `codes`/`filled` instead of a dense x the layer runs the
    embedding-gather first layer (`locally_masked_embed`); `embed_classes`
    then fixes Cin = classes + 1 (the ones padding channel)."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 dilation: int = 1, use_bias: bool = True,
                 mask_weight: bool = False, compute_dtype: Optional[str] = None,
                 embed_classes: Optional[int] = None, backend: str = "xla"):
        super().__init__()
        if backend not in BACKENDS:
            raise NotImplementedError(f"LMConv backend {backend!r}: one of {BACKENDS}")
        if embed_classes:
            cin = embed_classes + 1
        k2 = kernel * kernel
        self.kernel, self.dilation = kernel, dilation
        self.compute_dtype, self.embed_classes, self.backend = (
            compute_dtype, embed_classes, backend)
        self.weight = nn.Parameter(torch.zeros(k2, cin, features),
                                   requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(features), requires_grad=False)
                     if use_bias else None)
        self.mask_weight = (nn.Parameter(torch.zeros(k2, features),
                                         requires_grad=False)
                            if mask_weight else None)
        self._cast = None    # ((weight version, device), the kernel's weight)

    def reset(self, gen):
        """weight and mask_weight ~ U(+-sqrt(1/fan_in)) (variance scaling
        1/3, fan_in, uniform); bias ~ U(+-1/sqrt(fan_in)), NOT zeros: the
        first pixel of every order has a blank mask, and a zero bias would
        leave it identically zero through every PONO."""
        k2, cin, _ = self.weight.shape

        def uniform(p, bound):
            p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)

        uniform(self.weight, 1.0 / np.sqrt(cin * k2))
        if self.bias is not None:
            uniform(self.bias, 1.0 / np.sqrt(cin * k2))
        if self.mask_weight is not None:
            uniform(self.mask_weight, 1.0 / np.sqrt(k2))

    def load_flax(self, node):
        for name in ("weight", "bias", "mask_weight"):
            p = getattr(self, name)
            if p is not None:
                p.copy_(_t(node[name], p))

    def to_flax(self):
        return {name: getattr(self, name).detach().cpu().numpy().astype(np.float32)
                for name in ("weight", "bias", "mask_weight")
                if getattr(self, name) is not None}

    def _kernel_weight(self):
        """The weight as the kernel reads it, made once per version of the
        weight: the bf16 cast, on the card as `PackedTaps` (the kernel's
        shared-memory image) where the bf16 kernel takes the shape."""
        if self.compute_dtype == "float32":
            return self.weight
        key = (self.weight._version, self.weight.device)
        if self._cast is None or self._cast[0] != key:
            w = self.weight.detach().to(torch.bfloat16)
            width = kernel_width(w.shape[1], w.shape[2])
            if w.is_cuda and w.shape[0] == 9 and width:
                w = prepare_taps(w, width)
            self._cast = (key, w)
        return self._cast[1]

    def forward(self, x, mask, *, codes=None, filled=None):
        if codes is not None:
            assert self.embed_classes is not None and self.dilation == 1
            return locally_masked_embed(codes, filled, raw_mask(mask),
                                        self.weight, self.bias,
                                        num_classes=self.embed_classes)
        if self.backend == "pallas":
            w = self.weight if self.weight.requires_grad else self._kernel_weight()
            cdt = self.compute_dtype or "bfloat16"
            wants_grad = torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (x, self.weight, self.bias))
            if wants_grad:
                out = locally_masked_conv2d_kernel_vjp(x, mask, w, self.bias,
                                                       self.dilation, cdt)
            else:
                # the vjp entry's forward: a shape the bf16 kernel does not
                # take (the one-hot first layer, Cin 513) runs the f32
                # kernel on bf16-rounded operands
                out = k3_layer_conv(x, mask, w, self.bias, dilation=self.dilation,
                                    compute_dtype=cdt)
            if self.mask_weight is not None:
                # the learned term on the mask itself is no part of the
                # kernel: one (HW, k*k) @ (k*k, Cout) product beside it
                B, H, W, _ = x.shape
                mw = self.mask_weight.to(getattr(torch, cdt)).float()
                out = out + mask_rows(raw_mask(mask), B, H, W).float() @ mw
            return out
        dtype = torch.bfloat16 if self.compute_dtype == "bfloat16" else None
        return locally_masked_conv2d(x, raw_mask(mask), self.weight, self.bias,
                                     self.mask_weight, dilation=self.dilation,
                                     compute_dtype=dtype)


class FeatureNorm(nn.Module):
    """pono | order_rescale | none (lmconv.py:103-114)."""

    def __init__(self, kind: str = "pono"):
        super().__init__()
        if kind not in ("pono", "order_rescale", "none"):
            raise NotImplementedError(f"feature_norm {kind!r}")
        self.kind = kind

    def forward(self, x, mask=None):
        if self.kind == "pono":
            return pono(x)
        if self.kind == "order_rescale":
            return order_rescale(x, raw_mask(mask))
        return x


class GatedResnet(FlaxNamed):
    """gated_resnet (lmconv.py:117-145); `skip` adds the nin-fused skip
    input `a` (the down pass)."""

    def __init__(self, nr_filters: int, kernel: int = 3,
                 feature_norm: str = "pono", dropout_prob: float = 0.0,
                 conv_bias: bool = True, conv_mask_weight: bool = False,
                 compute_dtype: Optional[str] = None, backend: str = "xla",
                 skip: bool = False):
        super().__init__()
        Fc = nr_filters
        kw = dict(compute_dtype=compute_dtype, backend=backend)
        self.add("LMConv", LMConv(2 * Fc, Fc, kernel, 1, conv_bias,
                                  conv_mask_weight, **kw))
        if skip:
            self.add("Nin", Nin(2 * Fc, Fc))
        self.add("LMConv", LMConv(2 * Fc, 2 * Fc, kernel, 1, conv_bias,
                                  conv_mask_weight, **kw))
        self.norm = FeatureNorm(feature_norm)
        self.dropout_prob = dropout_prob
        self.has_skip = skip

    def load_flax(self, node):
        for name, child in self.named_children():
            if name != "norm":
                child.load_flax(node[name])

    def to_flax(self):
        return {name: child.to_flax() for name, child in self.named_children()
                if name != "norm"}

    def reset(self, gen):
        for name, child in self.named_children():
            if name != "norm":
                child.reset(gen)

    def forward(self, og_x, a=None, *, mask, gen: Optional[torch.Generator] = None):
        x = self.LMConv_0(concat_elu(og_x), mask)
        x = self.norm(x, mask)
        if a is not None:
            x = x + self.Nin_0(concat_elu(a))
        x = concat_elu(x)
        if self.dropout_prob > 0 and self.training:
            # Flax nn.Dropout: keep with 1 - p, scaled by 1 / (1 - p); the
            # draw comes from `gen` (the global batch's, sliced, in a mesh)
            keep = draw_rows(torch.rand, x.shape, generator=gen,
                             device=x.device) >= self.dropout_prob
            x = torch.where(keep, x / (1.0 - self.dropout_prob), 0.0)
        x = self.LMConv_1(x, mask)
        a_out, b_out = torch.chunk(x, 2, dim=-1)
        return og_x + self.norm(a_out, mask) * torch.sigmoid(b_out)


class LMPixelCNN(FlaxNamed):
    """OurPixelCNN (lmconv.py:148-236): the 512-way code-grid prior."""

    def __init__(self, nr_resnet: int = 2, nr_filters: int = 80,
                 input_channels: int = 512, kernel_size: int = 3,
                 max_dilation: int = 2, feature_norm: str = "pono",
                 dropout_prob: float = 0.0, conv_bias: bool = True,
                 conv_mask_weight: bool = False, num_classes: int = 512,
                 compute_dtype: Optional[str] = None, backend: str = "xla"):
        super().__init__()
        Fc, k, nr = nr_filters, kernel_size, nr_resnet
        self.nr_resnet, self.nr_filters = nr, Fc
        self.input_channels, self.num_classes = input_channels, num_classes
        self.max_dilation, self.compute_dtype = max_dilation, compute_dtype
        self.feature_norm, self.conv_mask_weight = feature_norm, conv_mask_weight
        kw = dict(compute_dtype=compute_dtype, backend=backend)

        def conv(dilation=1, embed=False):
            return LMConv(Fc, Fc, k, dilation, conv_bias, conv_mask_weight,
                          embed_classes=input_channels if embed else None, **kw)

        def gated(skip):
            return GatedResnet(Fc, k, feature_norm, dropout_prob, conv_bias,
                               conv_mask_weight, skip=skip, **kw)

        # creation order is Flax's call order: the names must match
        self.add("LMConv", conv(embed=True))
        for _ in range(2):
            for _ in range(nr):
                self.add("GatedResnet", gated(False))
            self.add("LMConv", conv(max_dilation))
        for _ in range(nr):
            self.add("GatedResnet", gated(False))
        self.down_nr = [nr, nr + 1, nr + 1]
        for i in range(2):
            for _ in range(self.down_nr[i]):
                self.add("GatedResnet", gated(True))
            self.add("LMConv", conv(max_dilation))
        for _ in range(self.down_nr[2]):
            self.add("GatedResnet", gated(True))
        self.add("Nin", Nin(Fc, num_classes))
        self.norm = FeatureNorm(feature_norm)

    def load_flax(self, node):
        for name, child in self.named_children():
            if name != "norm":
                child.load_flax(node[name])

    def to_flax(self):
        return {name: child.to_flax() for name, child in self.named_children()
                if name != "norm"}

    def reset(self, gen):
        for name, child in self.named_children():
            if name != "norm":
                child.reset(gen)

    def forward(self, x, mask_init, mask_undilated, mask_dilated, *,
                codes=None, filled=None, gen: Optional[torch.Generator] = None):
        """x (B, H, W, input_channels) one-hot codes, or None with `codes`
        (B, H, W) int and `filled` (B, H, W): the first layer is then the
        per-tap embedding gather.  masks (B, k^2, H*W).  Returns logits
        (B, H, W, num_classes).  In train mode a `dropout_prob` > 0 draws
        its masks from `gen`."""
        nr = self.nr_resnet
        g = d = 0

        def gated(u, a=None):
            nonlocal g
            out = getattr(self, f"GatedResnet_{g}")(u, a, mask=mask_undilated, gen=gen)
            g += 1
            return out

        def dconv(u):
            nonlocal d
            d += 1
            return self.norm(getattr(self, f"LMConv_{d}")(u, mask_dilated),
                             mask_dilated)

        ### UP PASS
        if codes is not None:
            if filled is None:
                filled = torch.ones(codes.shape, device=codes.device)
            u0 = self.LMConv_0(None, mask_init, codes=codes, filled=filled)
        else:
            ones = torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
            u0 = self.LMConv_0(torch.cat([x, ones], -1), mask_init)
        u_list: List[torch.Tensor] = [self.norm(u0, mask_undilated)]
        for _ in range(2):
            for _ in range(nr):
                u_list.append(gated(u_list[-1]))
            u_list.append(dconv(u_list[-1]))
        for _ in range(nr):
            u_list.append(gated(u_list[-1]))

        ### DOWN PASS
        u = u_list.pop()
        for i in range(2):
            for _ in range(self.down_nr[i]):
                u = gated(u, u_list.pop())
            u = dconv(u)
        for _ in range(self.down_nr[2]):
            u = gated(u, u_list.pop())
        assert not u_list, f"skip list imbalance: {len(u_list)} left"
        return self.Nin_0(F.elu(u))


def flax_named_params(model: LMPixelCNN) -> Dict[str, torch.Tensor]:
    """The module's parameters under their flat Flax names
    ("GatedResnet_3/LMConv_0/weight", ".../Nin_0/Dense_0/kernel" as (in,
    out)): what `pack_lmconv_params` and `pixelcnn_forward_fast` read."""
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if len(parts) >= 2 and parts[-2].startswith("Dense"):
            if parts[-1] == "weight":
                parts[-1], p = "kernel", p.T
        out["/".join(parts)] = p.detach()
    return out
