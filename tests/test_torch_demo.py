"""The port's demo CLI end to end on the CPU: the trained stitched
checkpoint, one novel view from an .npy input image."""

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
    assert written == ["input_fs_image_R_0.png", "output_image_R_0.png"] or \
        written == ["input_fs_image_R_0.npy", "output_image_R_0.npy"]
