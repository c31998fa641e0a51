"""Scene generation: the cumulative multi-view walk with batched sampling
(port of pixelsynth_tpu/scene.py).

Per direction, render the full-rotation view first, then sweep back toward
the input, carrying the growing point cloud; at every view all
num_samples outpainting candidates advance together through one sampling
population, and the best candidate per item is picked by discriminator
score and classifier entropy (z_buffermodel.py:244-276).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pixelsynth_tpu_torch.geometry.paths import get_rt_from_rot, num_split_for_direction
from pixelsynth_tpu_torch.models.classifier import (
    classifier_entropy, preprocess_for_classifier,
)
from pixelsynth_tpu_torch.parallel.mesh import Mesh, all_gather_rows, data_sharding
from pixelsynth_tpu_torch.pipeline import CloudState, PixelSynth, refuse_what_jax_cannot
from pixelsynth_tpu_torch.sampling import (
    ar_sample, ar_sample_speculative, d_fake_score, rank_candidates,
)
from pixelsynth_tpu_torch.utils.devices import put_variables


def _tile(x: torch.Tensor, s: int) -> torch.Tensor:
    return torch.repeat_interleave(x, s, dim=0)


class StageTimer:
    """Per-stage device time: CUDA events around each stage on the card
    (read after a synchronize), the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.spans: List[Tuple[str, object, object]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.cuda:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            yield
            e.record()
        else:
            s = time.perf_counter()
            yield
            e = time.perf_counter()
        self.spans.append((name, s, e))

    def times_ms(self) -> Dict[str, float]:
        if self.cuda:
            torch.cuda.synchronize()
        out: Dict[str, float] = {}
        for name, s, e in self.spans:
            ms = s.elapsed_time(e) if self.cuda else (e - s) * 1e3
            out[name] = out.get(name, 0.0) + ms
        return out


def _no_timer(name: str):
    return contextlib.nullcontext()


class SceneGenerator:
    """Drives single views and scene walks of one PixelSynth.

    noise_mode: the decoder's noise-conditioned BN draws -- "per_view"
      (a fresh draw every view, the reference), "fixed" (one draw per
      scene, reused by every view) or "zero" (deterministic, gain 1 /
      bias 0).
    carry: what the walk re-encodes as the next view's input -- "decoder"
      (the reference: the refined image) or "composite" (the
      pre-refinement composite of splat and VQ-decoded outpaint).
    anchor_input: reset the carried image to the true input when the walk
      renders at the input pose.
    mesh: a parallel/mesh.py Mesh with a process group (JAX's `mesh`,
      scene.py:51-58): the weights are replicated from rank 0, and each
      rank samples and decodes its contiguous slice of the B*S candidates
      (B*S must divide by the world size), drawing the whole population's
      noise and keeping its slice (parallel/mesh.py `draw_rows`); the ranks then
      all-gather the codes, composites and images before the
      discriminator and classifier re-rank them, so every rank returns
      the same best view, and the candidates are those of one process."""

    def __init__(self, ps: PixelSynth, *, num_samples: Optional[int] = None,
                 temperature: Optional[float] = None,
                 cloud_capacity: int = 4 * 65536,
                 noise_mode: Optional[str] = None, carry: Optional[str] = None,
                 anchor_input: Optional[bool] = None, mesh: Optional[Mesh] = None):
        refuse_what_jax_cannot(ps.cfg, scene=True)
        sc = ps.cfg.sample
        self.ps = ps
        self.device = ps.device
        self.num_samples = num_samples if num_samples is not None else sc.num_samples
        self.temperature = temperature if temperature is not None else sc.temperature
        self.cloud_capacity = cloud_capacity
        self.noise_mode = noise_mode if noise_mode is not None else sc.noise_mode
        assert self.noise_mode in ("per_view", "fixed", "zero"), self.noise_mode
        self.carry = carry if carry is not None else sc.carry
        assert self.carry in ("decoder", "composite"), self.carry
        self.anchor_input = anchor_input if anchor_input is not None else sc.anchor_input
        self._noise_scale = 0.0 if self.noise_mode == "zero" else 1.0
        if ps.classifier is None and self.num_samples > 1:
            import warnings

            warnings.warn("SceneGenerator: no classifier weights; candidate "
                          "re-ranking uses the discriminator score only",
                          stacklevel=2)
        self.timer = _no_timer
        self.mesh = mesh if mesh is not None and mesh.distributed else None
        if self.mesh is not None:
            put_variables([getattr(ps, t) for t in ps.trees], self.mesh)
            put_variables(getattr(ps, "packed", None), self.mesh)

    def _gen(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _dev(self, x) -> torch.Tensor:
        """numpy or tensor -> float32 tensor on this generator's device."""
        if not torch.is_tensor(x):
            x = torch.tensor(np.asarray(x))
        return x.to(device=self.device, dtype=torch.float32)

    def _cams(self, cams) -> Dict[str, torch.Tensor]:
        return {k: self._dev(v) for k, v in cams.items()}

    @torch.no_grad()
    def _view_step(self, img, cams, cloud: CloudState, last_bg, RTinv_last,
                   gen: torch.Generator, noise_gen: torch.Generator):
        ps, S, T = self.ps, self.num_samples, self.timer
        with T("depth"):
            depth = ps.regress_depth(img)
        fs = ps.features(img)
        with T("splat"):
            gen_fs, bg, new_cloud = ps.splat_cumulative(fs, depth, cams, cloud,
                                                        last_bg, RTinv_last)
        with T("orders_masks"):
            order, masks, bg_ds = ps.masks_for_background(bg)
        with T("encode"):
            codes = ps.vq_encode(gen_fs)
        B = img.shape[0]
        stats = sampled = None
        if bool((bg_ds >= 1.0 - 1e-6).any()):
            # the population: all B*S candidates, or this rank's slice of
            # them in a mesh (gathered after the decode)
            if self.mesh is not None:
                rows = data_sharding(self.mesh, B * S)
                pop, in_mesh = (lambda x: _tile(x, S)[rows]), self.mesh
            else:
                pop, in_mesh = (lambda x: _tile(x, S)), contextlib.nullcontext()
            with in_mesh, T("ar_fill"):
                l = ps.cfg.model.lmconv
                logits_fn = ps.make_sampling_logits_fn(pop(masks))
                spec = ps.cfg.sample.speculative
                args = (logits_fn, pop(codes), pop(order), pop(bg_ds), gen)
                kw = dict(num_classes=l.num_classes, temperature=self.temperature)
                if spec > 0:
                    sampled, stats = ar_sample_speculative(*args, spec=spec,
                                                           return_stats=True, **kw)
                else:
                    sampled = ar_sample(*args, **kw)
            with in_mesh, T("decode"):
                decoded = ps.vq_decode(sampled)
                combined = ps.combine(pop(gen_fs), decoded, pop(bg))
                gen_imgs = ps.decode_image(combined, pop(bg),
                                           noise_scale=self._noise_scale,
                                           gen=noise_gen)
                sampled, combined, gen_imgs = (all_gather_rows(x) for x in
                                               (sampled, combined, gen_imgs))
            with T("rank"):
                d_scores = d_fake_score(ps.disc, gen_imgs, _tile(img, S))
                if ps.classifier is not None:
                    entropy = classifier_entropy(ps.classifier(
                        preprocess_for_classifier(gen_imgs * 0.5 + 0.5)))
                else:
                    entropy = torch.zeros(B * S, device=img.device)
        else:
            # nothing to outpaint: decode once per item and broadcast
            with T("decode"):
                decoded = ps.vq_decode(codes)
                combined = ps.combine(gen_fs, decoded, bg)
                one = ps.decode_image(combined, bg, noise_scale=self._noise_scale,
                                      gen=noise_gen)
                gen_imgs, combined = _tile(one, S), _tile(combined, S)
                d_scores = entropy = torch.zeros(B * S, device=img.device)
        with T("rank"):
            best = torch.stack([rank_candidates(d, e) for d, e in zip(
                d_scores.reshape(B, S), entropy.reshape(B, S))])
            best_idx = torch.arange(B, device=img.device) * S + best
            best_img = gen_imgs[best_idx]
        return {
            "gen_imgs": gen_imgs, "d_scores": d_scores, "entropy": entropy,
            "best_img": best_img,
            "best_carry": combined[best_idx] if self.carry == "composite" else best_img,
            "bg": bg, "depth": depth, "gen_fs": gen_fs, "cloud": new_cloud,
            "codes": codes, "order": order, "masks": masks, "bg_ds": bg_ds,
            "sampled": sampled,
            "ar_stats": stats,
        }

    def generate_view(self, img, cams, cloud: CloudState, last_bg, RTinv_last,
                      seed: int = 0, noise_seed: Optional[int] = None):
        """One outpainted view for a batch of B items: B*S candidates
        (item-major), the best per item rank-selected.  img (B, W, W, 3) in
        [-1, 1]; cams: K, Kinv, P_in, Pinv_in, P_out (B, 4, 4).  Returns
        ((B, W, W, 3) best images, raw step outputs)."""
        img = self._dev(img)
        cams = self._cams(cams)
        RTinv_last = self._dev(RTinv_last)
        if noise_seed is None:
            noise_seed = int(seed) * 2 + 1
        out = self._view_step(img, cams, cloud, last_bg, RTinv_last,
                              self._gen(seed), self._gen(noise_seed))
        return out["best_img"], out

    def generate_scene(self, img, K, Kinv, P_in, Pinv_in, *,
                       directions: Optional[List[str]] = None,
                       num_split: Optional[int] = None,
                       seed: int = 0, two_imgs: bool = False,
                       sequential: bool = False) -> Dict[str, np.ndarray]:
        """Full scene walk (z_buffermodel.py:421-592): per direction the
        full rotation first, then back toward the input (:471-529), or with
        `sequential` outward from the input, numerators 0..n
        (opt.sequential_outpainting, :531-589).  `two_imgs` takes the split
        counts of gen_two_imgs (num_split_for_direction).  Returns
        {"PredImg_<dir>_<i>": (B,W,W,3), ...} plus FeaturesImg per view,
        PredDepthImg / ForegroundImg for each full rotation, and
        CloudValidCount."""
        ps = self.ps
        sc = ps.cfg.sample
        directions = list(directions or sc.directions)
        base_split = num_split if num_split is not None else sc.num_split
        P_in = np.asarray(P_in)
        img = self._dev(img)
        B = img.shape[0]
        cloud = CloudState.empty(B, self.cloud_capacity, img.shape[-1], self.device)
        seeds = torch.Generator().manual_seed(int(seed))
        scene_noise = (int(torch.randint(1 << 62, (1,), generator=seeds))
                       if self.noise_mode == "fixed" else None)
        current, last_bg, RTinv_last = img, None, Pinv_in
        last_num = last_dir = None
        outputs: Dict[str, torch.Tensor] = {"InputImg": img}
        for direction in directions:
            n_split = num_split_for_direction(direction, base_split, two_imgs)
            nums = (list(range(n_split + 1)) if sequential
                    else [n_split] + list(reversed(range(n_split))))
            for num in nums:
                if last_num is None:
                    cin_inv, cin = Pinv_in, P_in
                else:
                    cin_inv, cin = get_rt_from_rot(last_dir, P_in, last_num, n_split)
                cout_inv, cout = get_rt_from_rot(direction, P_in, num, n_split)
                cams = {"K": K, "Kinv": Kinv, "P_in": cin, "Pinv_in": cin_inv,
                        "P_out": cout}
                view_seed = int(torch.randint(1 << 62, (1,), generator=seeds))
                best, out = self.generate_view(current, cams, cloud, last_bg,
                                               RTinv_last, view_seed, scene_noise)
                outputs[f"PredImg_{direction}_{num}"] = best
                outputs[f"FeaturesImg_{direction}_{num}"] = out["gen_fs"]
                if num == n_split:
                    outputs[f"PredDepthImg_{direction}_{num}"] = out["depth"]
                    outputs[f"ForegroundImg_{direction}_{num}"] = (~out["bg"]).float()
                if self.anchor_input and num == 0 and direction not in ("S", "C"):
                    current = img
                else:
                    current = out["best_carry"]
                cloud, last_bg, RTinv_last = out["cloud"], out["bg"], cout_inv
                last_num, last_dir = num, direction
        outputs["CloudValidCount"] = cloud.valid.sum(1)
        return {k: v.cpu().numpy() for k, v in outputs.items()}


def batch_rt_from_rot(directions: List[str], input_RT, num, denom):
    """Per-item camera paths: `get_rt_from_rot` over a batch whose
    direction differs per item (the consistency eval's per-index fixed
    directions, eval_consistency.py:101-149).  -> (RTinv, RT), each
    (B, 4, 4) float32 numpy."""
    input_RT = np.asarray(input_RT)
    invs, rts = [], []
    for b, d in enumerate(directions):
        inv, rt = get_rt_from_rot(d, input_RT[b], num, denom)
        invs.append(inv)
        rts.append(rt)
    return np.stack(invs), np.stack(rts)


class TwoImageGenerator(SceneGenerator):
    """Batched gen_two_imgs: the full and the half rotation of each item,
    each item in its own direction; the whole batch advances through one
    sampling population per view (the reference renders one item at a
    time, forward_scene with num_split=2, z_buffermodel.py:425-453)."""

    def generate_two_imgs(self, img, K, Kinv, P_in, Pinv_in,
                          directions: List[str], seed: int = 0) -> Dict[str, np.ndarray]:
        """img (B, W, W, 3) in [-1, 1]; K, Kinv, P_in, Pinv_in (B, 4, 4);
        directions: B names.  Renders numerators 2, 1, 0 of 2 in turn,
        carrying the cloud, the background and the carried image as
        `generate_scene` does.  Returns {"PredImg_2": full rotation,
        "PredImg_1": half, "PredImg_0": back at the input pose}."""
        P_in, Pinv_in = np.asarray(P_in), np.asarray(Pinv_in)
        img = self._dev(img)
        cloud = CloudState.empty(img.shape[0], self.cloud_capacity, img.shape[-1],
                                 self.device)
        seeds = torch.Generator().manual_seed(int(seed))
        scene_noise = (int(torch.randint(1 << 62, (1,), generator=seeds))
                       if self.noise_mode == "fixed" else None)
        outputs: Dict[str, torch.Tensor] = {}
        current, last_bg, RTinv_last = img, None, Pinv_in
        cin, cin_inv = P_in, Pinv_in
        for num in (2, 1, 0):
            cout_inv, cout = batch_rt_from_rot(directions, P_in, num, 2)
            cams = {"K": K, "Kinv": Kinv, "P_in": cin, "Pinv_in": cin_inv,
                    "P_out": cout}
            view_seed = int(torch.randint(1 << 62, (1,), generator=seeds))
            best, out = self.generate_view(current, cams, cloud, last_bg, RTinv_last,
                                           view_seed, scene_noise)
            outputs[f"PredImg_{num}"] = best
            current = out["best_carry"]
            cloud, last_bg, RTinv_last = out["cloud"], out["bg"], cout_inv
            cin, cin_inv = cout, cout_inv
        return {k: v.cpu().numpy() for k, v in outputs.items()}


def video_frame_order(num_split: int) -> List[Tuple[str, int]]:
    """Frame sequence of the demo video (demo.py:128-164): R 0, then for
    each of R L C C S S ascending 1..n-1 and, off the S/C paths, also
    descending n-1..0."""
    frames: List[Tuple[str, int]] = [("R", 0)]
    for direction in ["R", "L", "C", "C", "S", "S"]:
        n = num_split * 2 if direction in ("S", "C") else num_split
        frames.extend((direction, i) for i in range(1, n))
        if direction not in ("S", "C"):
            frames.extend((direction, i) for i in range(n - 1, -1, -1))
    return frames
