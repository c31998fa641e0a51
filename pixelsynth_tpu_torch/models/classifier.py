"""ResNet-18 scene classifier for candidate re-ranking (port of
pixelsynth_tpu/models/classifier.py), loaded from a `classifier` tree in
the `load_classifier_npz` layout (params + batch_stats).

The loaders return that tree as numpy, as the JAX package's return it:
`load_torch_resnet18` converts a torchvision resnet18 state dict exported
as npz (the Places365 weights of the reference, demo.py:233-243),
`load_classifier_npz` reads the slash-joined npz `save_classifier_npz`
writes (the in-repo scene classifier); `classifier_from_variables` builds
the module from either."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from pixelsynth_tpu_torch.models.layers import BatchNorm, Conv, Dense, FlaxNamed

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def classifier_entropy(logits: torch.Tensor) -> torch.Tensor:
    """Entropy of the softmax per candidate (z_buffermodel.py:259-261)."""
    p = torch.softmax(logits, dim=-1)
    return -(p * torch.log(torch.clamp(p, min=1e-12))).sum(-1)


def preprocess_for_classifier(img01: torch.Tensor) -> torch.Tensor:
    """[0,1] NHWC image -> 224x224 ImageNet-normalized NHWC
    (jax.image.resize bilinear, antialiased when shrinking)."""
    x = F.interpolate(img01.permute(0, 3, 1, 2), size=(224, 224),
                      mode="bilinear", align_corners=False,
                      antialias=img01.shape[1] > 224)
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (x.permute(0, 2, 3, 1) - mean) / std


class BasicBlock(FlaxNamed):
    def __init__(self, cin, features, stride=1):
        super().__init__()
        self.add("Conv", Conv(cin, features, 3, stride, 1, bias=False))
        self.add("BatchNorm", BatchNorm(features))
        self.add("Conv", Conv(features, features, 3, 1, 1, bias=False))
        self.add("BatchNorm", BatchNorm(features))
        self.proj = stride != 1 or cin != features
        if self.proj:
            self.add("Conv", Conv(cin, features, 1, stride, 0, bias=False))
            self.add("BatchNorm", BatchNorm(features))

    def forward(self, x):
        h = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        h = self.BatchNorm_1(self.Conv_1(h))
        if self.proj:
            x = self.BatchNorm_2(self.Conv_2(x))
        return torch.relu(h + x)


class ResNet18(FlaxNamed):
    def __init__(self, num_classes=365):
        super().__init__()
        self.add("Conv", Conv(3, 64, 7, 2, 3, bias=False))
        self.add("BatchNorm", BatchNorm(64))
        cin = 64
        self.blocks = []
        for feats, stride in [(64, 1), (64, 1), (128, 2), (128, 1),
                              (256, 2), (256, 1), (512, 2), (512, 1)]:
            self.blocks.append(self.add("BasicBlock", BasicBlock(cin, feats, stride)))
            cin = feats
        self.add("Dense", Dense(512, num_classes))

    def forward(self, x):
        """x (B, 224, 224, 3) normalized NHWC -> (B, num_classes) logits."""
        h = torch.relu(self.BatchNorm_0(self.Conv_0(x.permute(0, 3, 1, 2))))
        h = F.max_pool2d(h, 3, 2, 1)
        for blk in self.blocks:
            h = blk(h)
        return self.Dense_0(h.mean((2, 3)))


def load_torch_resnet18(npz_path: str) -> Dict:
    """A torchvision resnet18 state dict exported as npz -> ResNet18
    variables (params + batch_stats, numpy)."""
    raw = dict(np.load(npz_path).items())

    def conv(k):
        return {"kernel": raw[k].transpose(2, 3, 1, 0)}

    def bn(prefix):
        return ({"scale": raw[f"{prefix}.weight"], "bias": raw[f"{prefix}.bias"]},
                {"mean": raw[f"{prefix}.running_mean"], "var": raw[f"{prefix}.running_var"]})

    params: Dict[str, Any] = {"Conv_0": conv("conv1.weight")}
    stats: Dict[str, Any] = {}
    params["BatchNorm_0"], stats["BatchNorm_0"] = bn("bn1")
    for idx, (layer, sub) in enumerate((l, s) for l in range(1, 5) for s in range(2)):
        base = f"layer{layer}.{sub}"
        p: Dict[str, Any] = {"Conv_0": conv(f"{base}.conv1.weight"),
                             "Conv_1": conv(f"{base}.conv2.weight")}
        st: Dict[str, Any] = {}
        p["BatchNorm_0"], st["BatchNorm_0"] = bn(f"{base}.bn1")
        p["BatchNorm_1"], st["BatchNorm_1"] = bn(f"{base}.bn2")
        if f"{base}.downsample.0.weight" in raw:
            p["Conv_2"] = conv(f"{base}.downsample.0.weight")
            p["BatchNorm_2"], st["BatchNorm_2"] = bn(f"{base}.downsample.1")
        params[f"BasicBlock_{idx}"], stats[f"BasicBlock_{idx}"] = p, st
    params["Dense_0"] = {"kernel": raw["fc.weight"].T, "bias": raw["fc.bias"]}
    return {"params": params, "batch_stats": stats}


def classifier_num_classes(variables: Dict) -> int:
    """The class count of ResNet18 variables (the final Dense kernel's
    width): Places365's 365, or the in-repo world classifier's count
    (tools/train_scene_classifier.py)."""
    return int(np.asarray(variables["params"]["Dense_0"]["kernel"]).shape[-1])


def save_classifier_npz(path: str, variables: Dict) -> None:
    """ResNet18 variables -> one npz of slash-joined keys."""
    from pixelsynth_tpu_torch.weights import flatten_tree

    np.savez_compressed(path, **flatten_tree(variables))


def load_classifier_npz(path: str) -> Dict:
    """Inverse of save_classifier_npz (numpy leaves)."""
    from pixelsynth_tpu_torch.weights import unflatten_tree

    with np.load(path) as z:
        return unflatten_tree({k: z[k] for k in z.files})


def classifier_from_variables(variables: Dict) -> ResNet18:
    """A ResNet18 (on the CPU, eval mode) loaded from classifier variables
    of any label space (the Dense kernel's width)."""
    from pixelsynth_tpu_torch.weights import merge_collections

    model = ResNet18(classifier_num_classes(variables))
    with torch.no_grad():
        model.load_flax(merge_collections(variables))
    return model.eval()
