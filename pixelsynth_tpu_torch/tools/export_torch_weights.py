"""Export torchvision / Places365 / FID-Inception / LPIPS weights to the npz
files the port's loaders read (port of
pixelsynth_tpu/tools/export_torch_weights.py; the same files, the same
keys, so either package reads them).

Run it once where those packages and their pretrained weights are
installed.  It never downloads: a weight file that is not in torch.hub's
cache already is not loaded, and a missing package or weight is printed by
name and its file skipped:

  python -m pixelsynth_tpu_torch.tools.export_torch_weights --out weights/ \\
      [--places365-ckpt resnet18_places365.pth.tar]

Produces:
  * vgg19_features.npz / vgg16_features.npz -> models/losses.load_torch_vgg19,
    eval/metrics.load_torch_vgg16 (perceptual loss + PercSim);
  * alexnet_features.npz / squeezenet_features.npz -> the PercSim
    --pnet_type variants (eval/metrics.py);
  * resnet18_places365.npz -> models/classifier.load_torch_resnet18
    (sample re-ranking);
  * inception_fid.npz -> eval/inception.load_torch_inception (pytorch_fid's
    FID-Inception, else torchvision's inception_v3; `blocks.` collapsed);
  * lpips_vgg_lin.npz -> eval/inception.load_lpips_lin_weights (the LPIPS
    vgg variant's linear layers).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np


def _cached(url: str) -> bool:
    """Is torch.hub's copy of `url` on disk (so loading it reads no network)?
    Prints the file's name when it is not."""
    import torch

    path = os.path.join(torch.hub.get_dir(), "checkpoints", os.path.basename(url))
    if not os.path.exists(path):
        print(f"{os.path.basename(url)} is not in {os.path.dirname(path)}: skipped "
              "(nothing is downloaded)")
        return False
    return True


def export_features(module, path: str) -> int:
    """A module's state dict, key for key, to an npz.  -> arrays written."""
    state = {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}
    np.savez(path, **state)
    print(f"wrote {path} ({len(state)} arrays)")
    return len(state)


def export_torchvision(out: str) -> None:
    """torchvision's ImageNet VGG19 / VGG16 / AlexNet / SqueezeNet 1.1
    feature stacks, where torchvision and its cached weights are present."""
    try:
        import torchvision
    except ImportError as e:
        print(f"torchvision unavailable: {e}")
        return
    for name, fname in (("vgg19", "vgg19_features.npz"), ("vgg16", "vgg16_features.npz"),
                        ("alexnet", "alexnet_features.npz"),
                        ("squeezenet1_1", "squeezenet_features.npz")):
        try:
            weights = torchvision.models.get_model_weights(name).IMAGENET1K_V1
            if _cached(weights.url):
                export_features(torchvision.models.get_model(name, weights=weights).features,
                                os.path.join(out, fname))
        except Exception as e:
            print(f"torchvision {name} weights unavailable: {e}")


def export_places365(ckpt_path: str, path: str) -> None:
    """resnet18_places365.pth.tar (the Places365 release) -> its state dict
    with the DataParallel `module.` prefix stripped."""
    import torch

    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    state = ckpt.get("state_dict", ckpt)
    state = {k.replace("module.", ""): v.cpu().numpy() for k, v in state.items()}
    np.savez(path, **state)
    print(f"wrote {path}")


def export_inception_fid(path: str) -> Optional[str]:
    """FID InceptionV3: pytorch_fid's FID-weights network (what `python -m
    pytorch_fid` scores with), else torchvision's inception_v3.  -> the
    source written, or None."""
    try:
        from pytorch_fid import inception as fid_inception

        url = getattr(fid_inception, "FID_WEIGHTS_URL", None)
        if url is not None and not _cached(url):
            raise FileNotFoundError(os.path.basename(url))
        net = fid_inception.InceptionV3([3])  # the pool3 block
        # collapse the block wrapper names back to torch module names
        state = {}
        for k, v in net.state_dict().items():
            k = k.split(".", 2)[-1] if k.startswith("blocks.") else k
            state[k] = v.detach().cpu().numpy()
        np.savez(path, **state)
        print(f"wrote {path} (pytorch_fid weights, {len(state)} arrays)")
        return "pytorch_fid"
    except Exception as e:
        print(f"pytorch_fid unavailable: {e}")
    try:
        import torchvision

        weights = torchvision.models.Inception_V3_Weights.IMAGENET1K_V1
        if not _cached(weights.url):
            return None
        net = torchvision.models.inception_v3(weights=weights, aux_logits=True)
        state = {k: v.detach().cpu().numpy() for k, v in net.state_dict().items()
                 if not k.startswith("AuxLogits") and not k.startswith("fc")}
        np.savez(path, **state)
        print(f"wrote {path} (torchvision weights, {len(state)} arrays)")
        return "torchvision"
    except Exception as e:
        print(f"torchvision inception unavailable: {e}")
    return None


def export_lpips_lin(path: str) -> bool:
    """The LPIPS vgg variant's linear calibration layers (the lpips release,
    shipped in its package) -> lin<i>.model.1.weight arrays.  The backbone
    is built random (pnet_rand), so torchvision loads no weights."""
    try:
        import lpips

        net = lpips.LPIPS(net="vgg", pnet_rand=True)
        state = {k: v.detach().cpu().numpy() for k, v in net.state_dict().items()
                 if ".model.1.weight" in k}
        np.savez(path, **state)
        print(f"wrote {path} ({len(state)} arrays)")
        return True
    except Exception as e:
        print(f"lpips unavailable: {e}")
        return False


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--places365-ckpt", default=None,
                    help="resnet18_places365.pth.tar (from the Places365 release)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    export_torchvision(args.out)
    if args.places365_ckpt:
        export_places365(args.places365_ckpt,
                         os.path.join(args.out, "resnet18_places365.npz"))
    export_inception_fid(os.path.join(args.out, "inception_fid.npz"))
    export_lpips_lin(os.path.join(args.out, "lpips_vgg_lin.npz"))


if __name__ == "__main__":
    main()
