"""Typed configuration for the PyTorch port (a copy of pixelsynth_tpu/config.py).

The port keeps its own copy so that it never imports the JAX package.  The
dataclasses, field names and defaults are identical, so the JSON config
stored in a stitched checkpoint (`evidence/relay/stitched.npz`) round-trips
through either package: `Config.to_json` / `Config.from_json` are lossless
and `Config.override` applies eval-time overrides.

Fields named for the TPU implementation keep their names and values
("pallas" included) so configs round-trip.  What the port reads, and what
each value selects on the card:

  * `splat.tile_size`, `splat.max_points_per_tile`: the binning tables;
    `splat.tile_group`: the plain blend's group size (CPU tensors only);
  * `splat.binning`: "argsort" = one sort over fused (tile, depth-bucket)
    keys; "counting" = a scatter into (tile, entry-rank) slots and an
    exact-f32 depth sort within each tile;
  * `splat.sort_backend` (argsort binning): "xla" = one library sort over
    the whole batch; "pallas" = per-image keys sorted by the hand-written
    kernel K5 (ops/sort_kernel.py) while an image's entries fit it;
  * `splat.blend_dtype`: "float32" = K2 reads f32 features; "bfloat16" =
    the features and each slot's weight rounded to bf16, the sums f32
    (K2's bf16 entry on the card);
  * `lmconv.sample_backend`: "fused" = the fused forward K1
    (ops/lmconv_fused.py) under the speculative sampler; "pallas" = the
    per-layer module with every masked conv through kernel K3
    (ops/masked_conv_kernel.py); "xla" = the module with the plain masked
    conv.  The last two sample one cell per forward;
  * `lmconv.train_backend` (the trainer's PixelCNN): "xla" = the plain
    masked conv; "pallas" = every masked conv through K3's differentiable
    entry, at `compute_dtype`;
  * `lmconv.compute_dtype`, `feature_norm`, `conv_mask_weight`,
    `dropout_prob` and the model's sizes.

  * `model.use_rgb_features`: True = the image is the point features;
    False = the `ResNetEncoder` of `refine_model_type` at `ngf` gives 64
    of them, splatted by K2 at that width into a decoder of that width;
  * `model.no_outpainting`: `render_no_outpaint` / `forward_angle` pass
    the decoder no mask channel; `model.predict_residual`,
    `normalize_before_residual`: the decoder's residual.

  * `lmconv.masks_backend` (pipeline.masks_for_background): "jax" = the
    device order builder (ops/orders_device.py: the CUDA kernel of
    csrc/custom_order.cu on the card, its plain loop on the CPU); "host" =
    the heap on the host (ops/orders.py).  Both give the same orders bit
    for bit.

Any other value of these fields raises NotImplementedError naming the
field.  So do the configurations the JAX package cannot compute
(pipeline.refuse_what_jax_cannot): a "modifier" in `depth_predictor_type`,
and with an encoder the trainer, the scene view step and
`predict_residual=True`.  Not read: `model_type`, `vqvae.two_level` and
`lmconv.weight_norm`, which the JAX package reads nowhere either (the
baselines and the two-level VQ-VAE are built by their own classes,
models/baselines.py and models/vqvae.py; `weight_norm` appears only in its
config.py); `use_pallas`, which belongs to a path the port does not have
(the blend always runs K2).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass
class SplatConfig:
    """Soft z-buffer splatter (reference models/layers/z_buffer_layers.py:33-131)."""

    radius: float = 4.0              # --radius (pixels)
    pp_pixel: int = 128              # K points per pixel in the z-buffer
    tau: float = 1.0                 # alpha exponent
    rad_pow: int = 2                 # distance exponent
    accumulation: str = "alphacomposite"  # wsum | wsumnorm | alphacomposite
    background_smoothing_kernel_size: int = 13
    learn_default_feature: bool = True
    # implementation knobs (no reference equivalent).  Candidates are
    # z-sorted front-to-back, so per-tile capacity truncation drops only
    # the farthest points of an overfull tile.  Raise max_points_per_tile
    # for clouds that bury >1024 candidates in one 16 px tile.
    tile_size: int = 16              # image tile edge for binned rasterization
    max_points_per_tile: int = 1024  # static candidate-list capacity per tile
    tile_group: int = 16             # tiles processed per lax.map step
    use_pallas: bool = False         # use the Pallas kernel fast path
    # candidate binning: "argsort" = one whole-batch fused-key sort (fastest;
    # keeps the M closest-in-z per tile on overflow; 16-bit z buckets);
    # "counting" = scatter + exact-f32 per-tile z sort (bit-faithful to the
    # dense reference order, but entry-order truncation on overflow)
    binning: str = "argsort"
    # argsort-binning sort engine: "xla" = one library sort over the whole
    # batch; "pallas" = per-image bitonic network in kernel K5
    # (ops/sort_kernel, bit-identical output; the whole-batch sort runs
    # instead when an image's 4N entries exceed 2^19)
    sort_backend: str = "xla"
    # blend math dtype for the per-tile weight x feature contraction and
    # the feature gathers feeding it ("float32" | "bfloat16"): bf16 halves
    # the blend's HBM traffic; alpha/z math always stays f32 and the dot
    # accumulates in f32 (see evidence/splat_blend_r4.json for timing)
    blend_dtype: str = "float32"


@dataclass
class VQVAEConfig:
    """Top-only VQ-VAE-2 (reference models/vqvae2/vqvae.py:240-312)."""

    in_channel: int = 3
    channel: int = 128
    n_res_block: int = 2
    n_res_channel: int = 32
    embed_dim: int = 64
    n_embed: int = 512
    decay: float = 0.99
    eps: float = 1e-5
    two_level: bool = False          # full VQVAE (vqvae.py:164-238) when True


@dataclass
class LMConvConfig:
    """Locally-masked PixelCNN (reference models/lmconv/model.py:61-155;
    PixelSynth instantiation at models/z_buffermodel.py:62-74)."""

    nr_resnet: int = 2
    nr_filters: int = 80
    input_channels: int = 512        # one-hot VQ codes
    kernel_size: int = 3
    max_dilation: int = 2
    feature_norm: str = "pono"       # pono | order_rescale | none
    dropout_prob: float = 0.0
    conv_bias: bool = True
    conv_mask_weight: bool = False
    weight_norm: bool = False
    num_classes: int = 512
    # parameter EMA for sampling (models/lmconv/utils.py:635-653; --ema arg)
    ema_decay: Optional[float] = None
    obs: Tuple[int, int, int] = (3, 32, 32)  # (C, rows, cols) of the code grid
    # distance transform driving the generation order: "exact" (true L2) or
    # "chamfer" (cv2 maskSize=5-compatible -- use with reference-trained
    # weights, whose orders were built under the chamfer approximation,
    # z_buffermodel.py:672-674)
    dt_mode: str = "exact"
    # TPU implementation knobs:
    compute_dtype: str = "bfloat16"   # einsum compute dtype
    # AR-sampling backend: "fused" = whole network in two Pallas launches
    # (ops/lmconv_fused.py); "pallas" = per-layer kernels; "xla"
    sample_backend: str = "fused"
    train_backend: str = "xla"        # backend for the differentiable path
                                      # ("pallas" uses the custom-VJP kernel)
    # generation-order/mask builder inside the view step: "jax" = on-device
    # masked-argmax loop (ops/orders_jax.py); "host" = C++ heap behind one
    # pure_callback (the reference's Cython shape, z_buffermodel.py:690-699)
    # -- flip from profiling, both are bit-exact (tests/test_orders_jax.py)
    masks_backend: str = "jax"


@dataclass
class ModelConfig:
    """Pipeline model (reference models/z_buffermodel.py:29-118 + options)."""

    model_type: str = "zbuffer_pts"  # zbuffer_pts | viewappearance | tatarchenko
    refine_model_type: str = "resnet_256W8UpDown3"
    depth_predictor_type: str = "unet"
    norm_G: str = "sync:spectral_batch"
    ngf: int = 64
    ndf: int = 64
    W: int = 256
    min_z: float = 0.5
    max_z: float = 10.0
    use_rgb_features: bool = True    # PixelSynth uses RGB point features
    use_inverse_depth: bool = False
    use_gt_depth: bool = False
    train_depth: bool = False
    no_outpainting: bool = False
    predict_residual: bool = True
    normalize_before_residual: bool = False
    use_vqvae: bool = True
    unet_num_filters: int = 32
    splat: SplatConfig = field(default_factory=SplatConfig)
    vqvae: VQVAEConfig = field(default_factory=VQVAEConfig)
    lmconv: LMConvConfig = field(default_factory=LMConvConfig)
    compute_dtype: str = "bfloat16"  # matmul/conv compute dtype on TPU


@dataclass
class LossConfig:
    """Reference models/losses/* wiring ("--losses 1.0_l1 10.0_content")."""

    losses: Tuple[str, ...] = ("1.0_l1", "10.0_content")
    discriminator_losses: str = "pix2pixHD"
    gan_mode: str = "hinge"
    no_ganFeat_loss: bool = False
    lambda_feat: float = 10.0
    lambda_autoreg: Optional[float] = None
    normalize_image: bool = True


@dataclass
class TrainConfig:
    """Stage-2 (DPR) training loop (reference train_dpr.py + base_model.py)."""

    lr: float = 1.5e-4
    beta1: float = 0.0
    beta2: float = 0.9
    batch_size: int = 12
    num_accumulations: int = 1
    max_epoch: int = 500
    iters_per_epoch: int = 500
    val_iters: int = 50
    seed: int = 0
    init: str = ""                   # "" | normal | xavier | kaiming | orthogonal
    # rotation curriculum: +curriculum_step deg every curriculum_every epochs
    max_rotation: int = 10
    curriculum_every: int = 50
    curriculum_step: int = 10
    curriculum_max: int = 50
    # GAN learning-rate decay (discriminators.update_learning_rate:
    # linear decay from lr to 0 over niter_decay epochs after niter)
    niter: Optional[int] = None
    niter_decay: int = 100

    @property
    def lr_g(self) -> float:
        return self.lr / 2

    @property
    def lr_d(self) -> float:
        return self.lr * 2


@dataclass
class SampleConfig:
    """AR sampling / scene generation (reference demo.py, scripts/demo_scene.sh)."""

    temperature: float = 0.7
    num_samples: int = 50
    num_split: int = 32
    directions: Tuple[str, ...] = ("R", "L", "U", "D", "UL", "UR", "DR", "DL", "S", "C")
    rotation: float = 0.3
    sequential_outpainting: bool = False
    homography: bool = False
    # exact speculative multi-cell AR decoding (sampling.py:
    # ar_sample_speculative): commit 1..spec+1 cells per PixelCNN forward
    # while sampling from the identical joint distribution; 0 = off
    # (strictly one cell per forward, the reference's schedule).
    # The depth is a schedule choice, not a semantic one: every depth
    # samples the same joint distribution.
    speculative: int = 12
    # ---- scene-walk stability (see scene.SceneGenerator).  Reference-
    # faithful settings are noise_mode="per_view", carry="decoder"
    # (z_buffermodel.py:516,584 + fresh BN noise per forward); the product
    # defaults diverge deliberately to keep adjacent views from
    # flickering. ----
    noise_mode: str = "fixed"
    carry: str = "composite"
    anchor_input: bool = False


@dataclass
class MeshConfig:
    """Device mesh (replaces DataParallel / DDP / SyncBN with one mechanism)."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1          # -1: all devices on the data axis
    model_parallel: int = 1


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    sample: SampleConfig = field(default_factory=SampleConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    dataset: str = "realestate"
    train_data_path: str = ""
    test_data_path: str = ""

    # ---- serialization (checkpoint is the config source of truth) ----

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        return _from_dict(cls, d)

    def refresh_splat_perf_knobs(self) -> "Config":
        """Reset distribution-preserving performance knobs to the CURRENT
        defaults, in place (returns self for chaining).

        Checkpoint configs are the source of truth for model semantics,
        but splat tile_size/max_points_per_tile/tile_group (measured
        bit-identical output) and sample.speculative (the speculative
        sampler draws from the identical joint distribution at every
        depth, tests/test_sampling.py) are hardware schedule choices --
        an artifact saved before a re-tune should not pin the old
        schedule forever.  Called by demo.load_model when restoring an
        artifact; knobs that DO change semantics (radius, pp_pixel, tau,
        accumulation, temperature, num_samples, ...) are untouched."""
        fresh = SplatConfig()
        for f in ("tile_size", "max_points_per_tile", "tile_group"):
            setattr(self.model.splat, f, getattr(fresh, f))
        self.sample.speculative = SampleConfig().speculative
        return self

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    def override(self, **kv: Any) -> "Config":
        """Dotted-path overrides, e.g. override(**{"sample.temperature": 0.5})."""
        d = self.to_dict()
        for key, value in kv.items():
            node = d
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            if parts[-1] not in node:
                raise KeyError(f"unknown config key: {key}")
            node[parts[-1]] = value
        return Config.from_dict(d)


def _from_dict(cls: type, d: Any) -> Any:
    if not dataclasses.is_dataclass(cls):
        return d
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        sub = _FIELD_DATACLASSES.get((cls.__name__, f.name))
        if sub is not None and isinstance(v, dict):
            kwargs[f.name] = _from_dict(sub, v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


_FIELD_DATACLASSES = {
    ("Config", "model"): ModelConfig,
    ("Config", "loss"): LossConfig,
    ("Config", "train"): TrainConfig,
    ("Config", "sample"): SampleConfig,
    ("Config", "mesh"): MeshConfig,
    ("ModelConfig", "splat"): SplatConfig,
    ("ModelConfig", "vqvae"): VQVAEConfig,
    ("ModelConfig", "lmconv"): LMConvConfig,
}
