"""The port's demo CLI end to end on the CPU: the trained stitched
checkpoint, one novel view from an .npy input image; and its image I/O,
PNGs without PIL, against the JAX demo's (PIL)."""

import os

import numpy as np

from pixelsynth_tpu_torch import demo

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
    assert wide.shape == (1, 16, 16, 3) and ratio == 1.0
    assert np.abs(wide).max() <= 1.0
