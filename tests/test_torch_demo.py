"""The port's demo CLI end to end on the CPU: the trained stitched
checkpoint, one novel view from an .npy input image; and its image I/O,
PNGs without PIL, against the JAX demo's (PIL)."""

import os

import numpy as np
import pytest

from pixelsynth_tpu_torch import demo
from torch_threads import _few_torch_threads  # noqa: F401

STITCHED = os.path.join(os.path.dirname(__file__), "..", "evidence", "relay",
                        "stitched.npz")


def test_demo_gen_img_from_stitched_checkpoint(tmp_path):
    yy, xx = np.meshgrid(np.linspace(-1, 1, 96), np.linspace(-1, 1, 128),
                         indexing="ij")
    img = np.clip(0.8 * np.stack([np.sin(3 * xx), np.cos(2 * yy), xx * yy], -1),
                  -1, 1).astype(np.float32)
    np.save(tmp_path / "in.npy", img)
    out = tmp_path / "out"
    demo.main(["--img", str(tmp_path / "in.npy"), "--mode", "gen_img",
               "--ckpt-dir", STITCHED, "--device", "cpu", "--num-samples", "1",
               "--result-folder", str(out)])
    written = sorted(os.listdir(out))
    assert written == ["input_fs_image_R_0.png", "output_image_R_0.png"]


def test_demo_image_io_matches_the_jax_demo(tmp_path):
    """`save_image` writes what the JAX demo's `save_png` writes (the same
    [-1, 1] -> uint8 truncation), as a PNG any reader takes; `load_demo_image`
    reads a W x W PNG as the JAX demo's PIL path does, and resizes others."""
    from PIL import Image

    from pixelsynth_tpu.data.demo_data import load_demo_image as jax_load
    from pixelsynth_tpu.eval.harness import save_png as jax_save_png
    from pixelsynth_tpu_torch.data.demo_data import load_demo_image, save_image

    rng = np.random.default_rng(0)
    img = rng.uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    path = save_image(str(tmp_path / "port" / "view.png"), img)
    jax_save_png(str(tmp_path / "jax.png"), img)
    assert path.endswith(".png")
    assert np.array_equal(np.asarray(Image.open(path)),
                          np.asarray(Image.open(tmp_path / "jax.png")))
    got, ratio = load_demo_image(path, 32)
    want, want_ratio = jax_load(path, 32)
    assert ratio == want_ratio == 1.0 and got.shape == (1, 32, 32, 3)
    np.testing.assert_array_equal(got, want)
    wide, ratio = load_demo_image(str(tmp_path / "jax.png"), 16)
    want, want_ratio = jax_load(str(tmp_path / "jax.png"), 16)
    assert wide.shape == (1, 16, 16, 3) and ratio == want_ratio == 1.0
    within_one_level(wide, want)


def within_one_level(got, want, frac=0.01):
    """got and want, images in [-1, 1] from uint8, differ by at most one
    uint8 level (2/255), on at most `frac` of the values."""
    levels = np.abs(np.rint((np.asarray(got, np.float64) + 1) * 127.5)
                    - np.rint((np.asarray(want, np.float64) + 1) * 127.5))
    assert got.shape == want.shape
    assert levels.max() <= 1, levels.max()
    assert (levels > 0).mean() <= frac, (levels > 0).mean()


@pytest.mark.parametrize("shape, W", [((24, 40), 16), ((360, 640), 256)])
def test_demo_resize_matches_the_jax_demo(tmp_path, shape, W):
    """An image that is not W x W (a photograph's aspect) resized to W as
    the JAX demo's PIL BILINEAR resize does (antialiased when it shrinks):
    within one uint8 level on at most 1% of the values; the aspect ratio
    the same."""
    from PIL import Image

    from pixelsynth_tpu.data.demo_data import load_demo_image as jax_load
    from pixelsynth_tpu_torch.data.demo_data import load_demo_image

    img = np.random.default_rng(0).integers(0, 256, shape + (3,), dtype=np.uint8)
    path = str(tmp_path / "photo.png")
    Image.fromarray(img).save(path)
    got, ratio = load_demo_image(path, W)
    want, want_ratio = jax_load(path, W)
    assert ratio == want_ratio
    within_one_level(got, want)


def _write_torchvision_resnet18(path, num_classes, seed):
    """A torchvision resnet18 state dict (random, seeded) as npz."""
    rng = np.random.default_rng(seed)
    out = {"conv1.weight": rng.normal(0, 0.1, (64, 3, 7, 7))}

    def bn(prefix, c):
        out.update({f"{prefix}.weight": rng.uniform(0.5, 1.5, c),
                    f"{prefix}.bias": rng.normal(0, 0.1, c),
                    f"{prefix}.running_mean": rng.normal(0, 0.1, c),
                    f"{prefix}.running_var": rng.uniform(0.5, 1.5, c)})

    bn("bn1", 64)
    cin = 64
    for layer, c in zip(range(1, 5), (64, 128, 256, 512)):
        for sub in range(2):
            base = f"layer{layer}.{sub}"
            first = cin if sub == 0 else c
            out[f"{base}.conv1.weight"] = rng.normal(0, 0.05, (c, first, 3, 3))
            out[f"{base}.conv2.weight"] = rng.normal(0, 0.05, (c, c, 3, 3))
            bn(f"{base}.bn1", c)
            bn(f"{base}.bn2", c)
            if sub == 0 and first != c:
                out[f"{base}.downsample.0.weight"] = rng.normal(0, 0.1, (c, first, 1, 1))
                bn(f"{base}.downsample.1", c)
        cin = c
    out["fc.weight"] = rng.normal(0, 0.05, (num_classes, 512))
    out["fc.bias"] = rng.normal(0, 0.05, num_classes)
    np.savez(path, **{k: v.astype(np.float32) for k, v in out.items()})
    return path


def _write_torchvision_vgg19(path, seed):
    rng = np.random.default_rng(seed)
    out, cin, idx = {}, 3, 0
    for v in (64, 64, "P", 128, 128, "P", 256, 256, 256, 256, "P",
              512, 512, 512, 512, "P", 512, 512, 512, 512):
        if v == "P":
            idx += 1
            continue
        out[f"{idx}.weight"] = rng.normal(0, 0.05, (v, cin, 3, 3)).astype(np.float32)
        out[f"{idx}.bias"] = rng.normal(0, 0.05, v).astype(np.float32)
        cin, idx = v, idx + 2
    np.savez(path, **out)
    return path


def test_loaders_match_the_jax_loaders(tmp_path):
    """load_torch_vgg19, load_torch_resnet18 and the scene-classifier npz
    round trip give the JAX loaders' trees."""
    import jax

    from pixelsynth_tpu.models import classifier as jcls
    from pixelsynth_tpu.models.losses import load_torch_vgg19 as jax_vgg19
    from pixelsynth_tpu_torch.models import classifier as tcls
    from pixelsynth_tpu_torch.models.losses import load_torch_vgg19
    from pixelsynth_tpu_torch.weights import flatten_tree

    def same(got, want):
        want = flatten_tree(jax.device_get(want))
        got = flatten_tree(got)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])

    vgg = _write_torchvision_vgg19(str(tmp_path / "vgg19_features.npz"), 1)
    same(load_torch_vgg19(vgg), jax_vgg19(vgg))
    res = _write_torchvision_resnet18(str(tmp_path / "resnet18_places365.npz"), 7, 2)
    variables = tcls.load_torch_resnet18(res)
    same(variables, jcls.load_torch_resnet18(res))
    tcls.save_classifier_npz(str(tmp_path / "scene_classifier.npz"), variables)
    same(tcls.load_classifier_npz(str(tmp_path / "scene_classifier.npz")),
         jcls.load_classifier_npz(str(tmp_path / "scene_classifier.npz")))


def test_demo_weights_dir_loads_vgg19_and_reranks_with_its_classifier(tmp_path, monkeypatch):
    """--weights-dir: the VGG19 is loaded, and the Places365-layout
    ResNet-18 (7 classes here) replaces the stitched checkpoint's
    classifier in the re-ranking; without it the scene classifier npz does."""
    import torch

    from pixelsynth_tpu_torch import scene
    from pixelsynth_tpu_torch.models import classifier as tcls

    wdir = tmp_path / "weights"
    wdir.mkdir()
    vgg = _write_torchvision_vgg19(str(wdir / "vgg19_features.npz"), 3)
    _write_torchvision_resnet18(str(wdir / "resnet18_places365.npz"), 7, 4)
    classes = []
    entropy = scene.classifier_entropy
    monkeypatch.setattr(scene, "classifier_entropy",
                        lambda logits: classes.append(logits.shape[-1]) or entropy(logits))
    np.save(tmp_path / "in.npy", np.zeros((32, 32, 3), np.float32))
    demo.main(["--img", str(tmp_path / "in.npy"), "--mode", "gen_img",
               "--ckpt-dir", STITCHED, "--device", "cpu", "--num-samples", "2",
               "--weights-dir", str(wdir), "--result-folder", str(tmp_path / "out")])
    assert classes == [7]

    ps = demo.load_model(STITCHED, device="cpu")
    stitched_classes = ps.classifier.Dense_0.weight.shape[0]
    assert demo.load_ported_weights(ps, None) == {}
    monkeypatch.setenv("PIXELSYNTH_WEIGHTS", str(wdir))
    assert demo.load_ported_weights(ps, None) == {
        "vgg": vgg, "classifier": str(wdir / "resnet18_places365.npz")}
    raw = np.load(vgg)
    assert torch.equal(ps.vgg.Conv_12.weight, torch.as_tensor(raw["28.weight"]))
    assert ps.classifier.Dense_0.weight.shape[0] == 7 != stitched_classes
    variables = tcls.load_torch_resnet18(str(wdir / "resnet18_places365.npz"))
    variables["params"]["Dense_0"] = {"kernel": np.ones((512, 3), np.float32),
                                      "bias": np.zeros(3, np.float32)}
    tcls.save_classifier_npz(str(wdir / "scene_classifier.npz"), variables)
    os.remove(wdir / "resnet18_places365.npz")
    assert demo.load_ported_weights(ps, str(wdir))["classifier"] == str(
        wdir / "scene_classifier.npz")
    assert torch.equal(ps.classifier.Dense_0.weight, torch.ones(3, 512))


@pytest.fixture(scope="module")
def dpr_workdir(tmp_path_factory):
    """The work directory of a one-epoch tiny run_dpr."""
    from pixelsynth_tpu_torch.config import Config
    from pixelsynth_tpu_torch.train.loop import run_dpr
    from test_train_loops import tiny_cfg

    cfg = Config.from_json(tiny_cfg().to_json())
    cfg.sample.num_split = 1
    cfg.sample.directions = ("R", "U", "S")
    root = str(tmp_path_factory.mktemp("dpr_run"))
    run_dpr(cfg, root, epochs=1, iters_per_epoch=1, val_iters=1, log_fn=lambda s: None,
            device="cpu")
    return root


def test_load_model_serves_a_run_dpr_directory(dpr_workdir):
    """The trainer's checkpoint in the serving build: the U-Net, the
    refinement decoder and the discriminator compute what the trainer's
    modules compute in eval mode."""
    import torch

    from pixelsynth_tpu_torch.checkpoint import CheckpointManager
    from pixelsynth_tpu_torch.pipeline import build_modules

    ps = demo.load_model(dpr_workdir, device="cpu")
    state = CheckpointManager(os.path.join(dpr_workdir, "dpr")).restore()
    trained = build_modules(ps.cfg, trainable=True)
    for name in ("unet", "projector"):
        trained[name].load_state_dict(state["gen_vars"][name])
    trained["disc"].load_state_dict(state["disc_vars"])
    for m in trained.values():
        m.eval()
    W = ps.W
    x = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (2, W, W, 3)),
                        dtype=torch.float32)
    bg = torch.zeros(2, W, W, dtype=torch.bool)
    bg[:, : W // 2] = True
    with torch.no_grad():
        torch.testing.assert_close(ps.unet(x), trained["unet"](x), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(ps.projector(x, bg, noise_scale=0.0),
                                   trained["projector"](x, bg, noise_scale=0.0),
                                   rtol=1e-5, atol=1e-5)
        for a, b in zip(ps.disc(x), trained["disc"](x)):
            for u, v in zip(a, b):
                torch.testing.assert_close(u, v, rtol=1e-5, atol=1e-5)


def test_demo_gen_scene_from_run_dpr_with_fps_writes_frames_only(dpr_workdir, tmp_path, capsys):
    """gen_scene from the trainer's directory with --fps and no ffmpeg: the
    scene and the video frames, no mp4, no error."""
    from pixelsynth_tpu_torch.scene import video_frame_order

    np.save(tmp_path / "in.npy", np.zeros((64, 64, 3), np.float32))
    out = tmp_path / "out"
    demo.main(["--img", str(tmp_path / "in.npy"), "--mode", "gen_scene",
               "--ckpt-dir", dpr_workdir, "--device", "cpu", "--num-samples", "1",
               "--fps", "5", "--result-folder", str(out)])
    assert "video=frames only" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == ["scene", "video"]
    assert sorted(os.listdir(out / "scene")) == ["output_image_R_0001.png",
                                                 "output_image_U_0001.png"]
    frames = [(d, i) for d, i in video_frame_order(1) if d in ("R", "S")]
    assert len(os.listdir(out / "video")) == len(frames) > 0


def test_load_model_refuses_other_directories(tmp_path):
    with pytest.raises(SystemExit, match="orbax"):
        demo.load_model(str(tmp_path), device="cpu")
