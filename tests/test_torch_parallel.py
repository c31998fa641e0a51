"""Data parallelism across processes: N gloo processes on the CPU, the
global batch split N ways, against one process on the whole batch
(parallel/dryrun.py runs both).

  * one stage-2 G+D step (NoiseBN noise on, AR head included; float64 but
    for the PixelCNN and the splat), one stage-1 step with the
    data-dependent codebook init and the EMA codebooks (float64) and one
    stage-3 step with dropout 0.5 and a parameter EMA (float32) on a global
    batch of 4 over 2 ranks: losses, the gradients each optimizer is
    handed, every buffer (BatchNorm moments, spectral vectors, codebooks)
    to 1e-5 relative for float32 values and 1e-10 for float64 ones (1e-8
    for stage 2's float64 values, which pass through the float32 splat),
    every parameter update inside Adam's band of that gradient tolerance,
    and every parameter and buffer bit-identical across the ranks;
  * the sharded candidate population: 4 candidates over 2 ranks give
    exactly the one-process codes, and the same scores and best view (to
    1e-5), over a two-view walk;
  * `dryrun_multichip(2)`, the JAX package's dry run's twin;
  * the three training loops' mesh path (run_dpr, run_vqvae,
    run_lmconv) on 2 ranks against one process.
Every multi-process run has its own timeout (`run_ranks`)."""

import functools
import os

import numpy as np
import pytest
import torch

from torch_threads import _few_torch_threads  # noqa: F401

TIMEOUT = 240.0


@pytest.fixture(scope="module")
def runs():
    from pixelsynth_tpu_torch.parallel.dryrun import JOBS, reference, run_ranks

    return reference(JOBS), run_ranks(2, JOBS, timeout=TIMEOUT)


@pytest.mark.parametrize("job", ["dpr", "vqvae", "lmconv"])
def test_train_step_on_two_ranks_is_the_one_process_step(runs, job):
    from pixelsynth_tpu_torch.parallel.dryrun import compare, same_on_every_rank

    want, ranks = runs
    for got in ranks:
        errs = compare(job, got[job], want[job])
        assert {"metrics", "grads"} <= set(errs)
        assert ("buffers" in errs) == bool(want[job]["buffers"])
        assert ("ema" in errs) == (job == "lmconv")
    same_on_every_rank(ranks, job)


def test_stage2_step_moves_global_batch_statistics(runs):
    """The comparison is not vacuous: the stage-2 step updated the U-Net's
    and the decoder's BatchNorm running statistics from their defaults,
    and each rank's equal the one-process step's (moments of the global
    batch, not of the rank's half)."""
    want, ranks = runs
    stats = [k for k in want["dpr"]["buffers"] if k.endswith((".mean", ".var"))]
    assert any(k.startswith("unet.") for k in stats)
    assert any(k.startswith("projector.") for k in stats)
    for k in stats:
        default = 0.0 if k.endswith(".mean") else 1.0
        assert not np.allclose(want["dpr"]["buffers"][k], default), k
        for got in ranks:
            w = want["dpr"]["buffers"][k]
            assert np.abs(got["dpr"]["buffers"][k] - w).max() <= 1e-8 * np.abs(w).max(), k


def test_sharded_population_is_the_one_process_population(runs):
    """Each rank samples 2 of the 4 candidates; after the gather every rank
    holds the one-process codes of all 4, the same scores and best view,
    on both views of the walk."""
    from pixelsynth_tpu_torch.parallel.dryrun import compare

    want, ranks = runs
    assert len(want["population"]["views"]) == 2
    for got in ranks:
        errs = compare("population", got["population"], want["population"])
        assert errs["codes"] == 0.0
    for view in want["population"]["views"]:
        assert view["sampled"].shape[0] == 4
        # the candidates differ from each other: the draws were sliced, not
        # repeated
        assert len({v.tobytes() for v in view["sampled"]}) > 1


def test_dryrun_multichip_two_ranks():
    from pixelsynth_tpu_torch.parallel.dryrun import dryrun_multichip

    report = dryrun_multichip(2, timeout=TIMEOUT)
    assert set(report) == {"dpr", "population"}


def loops(mesh, cfg, *, workdir):
    """The three training loops, one epoch of one step each, on 4-item batches;
    -> their metrics and the files each rank sees."""
    from pixelsynth_tpu_torch.train.loop import run_dpr, run_lmconv, run_vqvae

    workdir = os.path.join(workdir, f"world{mesh.world_size}")
    cfg.dataset, cfg.train.batch_size = "synthetic", 4
    kw = dict(log_fn=lambda s: None, device="cpu")
    out = {
        "dpr": run_dpr(cfg, workdir, epochs=1, iters_per_epoch=1, val_iters=1, **kw),
        "vqvae": run_vqvae(cfg, workdir, epochs=1, iters_per_epoch=1, val_iters=1, **kw),
        "lmconv": run_lmconv(cfg, workdir, epochs=1, iters_per_epoch=1, val_iters=1,
                             preview_every=1, **kw),
    }
    mesh.barrier()
    out["files"] = sorted(os.path.relpath(os.path.join(d, f), workdir)
                          for d, _, fs in os.walk(workdir) for f in fs)
    return out


def test_training_loops_mesh_path(tmp_path):
    """run_dpr, run_vqvae and run_lmconv on 2 ranks report the one-process
    metrics (float32: 1e-5 relative; psnr_std, the ranks' mean, skipped)
    and rank 0 alone writes the checkpoints, logs and previews."""
    from pixelsynth_tpu_torch.parallel.dryrun import reference, run_ranks

    job = functools.partial(loops, workdir=str(tmp_path))
    want = reference([job])["loops"]
    ranks = [r["loops"] for r in run_ranks(2, [job], timeout=TIMEOUT)]
    for got in ranks:
        for stage in ("dpr", "vqvae", "lmconv"):
            assert set(got[stage]) == set(want[stage])
            for k, w in want[stage].items():
                if k != "psnr_std":
                    np.testing.assert_allclose(got[stage][k], w, rtol=1e-5,
                                               err_msg=f"{stage} {k}")
    assert ranks[0]["files"] == ranks[1]["files"] == want["files"]
    assert any(f.startswith("lmconv_samples/") for f in want["files"])


def test_mesh_without_a_group_is_one_process():
    """No process group: a mesh of one process whatever the configured
    sizes; shard_batch gives back the whole batch as tensors on the
    mesh's device and refuses a batch that does not divide; collectives
    are the identity; initialize_multihost without a world size is a
    no-op that returns 1."""
    from pixelsynth_tpu_torch.config import MeshConfig
    from pixelsynth_tpu_torch.parallel.distributed import initialize_multihost
    from pixelsynth_tpu_torch.parallel.mesh import (
        Mesh, all_gather_rows, data_sharding, draw_rows, make_mesh, shard_batch,
        sum_over_ranks,
    )
    from pixelsynth_tpu_torch.utils.devices import put_variables

    old = os.environ.pop("WORLD_SIZE", None)
    try:
        assert initialize_multihost() == 1
    finally:
        if old is not None:
            os.environ["WORLD_SIZE"] = old
    mesh = make_mesh(MeshConfig(data_parallel=2), device="cpu")
    assert (mesh.world_size, mesh.rank, mesh.group) == (1, 0, None)
    batch = {"a": np.arange(6.0).reshape(3, 2), "b": [np.ones((3, 1), np.int64)]}
    out = shard_batch(batch, mesh)
    assert torch.equal(out["a"], torch.arange(6.0, dtype=torch.float64).reshape(3, 2))
    assert out["b"][0].dtype == torch.int64
    two = Mesh(2, 1, None, "cpu")
    assert data_sharding(two, 4) == slice(2, 4)
    with pytest.raises(ValueError, match="does not divide"):
        data_sharding(two, 3)
    x = torch.arange(4.0)
    with mesh:
        assert sum_over_ranks(x) is x and all_gather_rows(x) is x
        g = torch.Generator().manual_seed(0)
        assert torch.equal(draw_rows(torch.rand, (3,), generator=g),
                           torch.rand((3,), generator=torch.Generator().manual_seed(0)))
    tree = put_variables({"w": np.ones(2, np.float32), "m": torch.nn.Linear(2, 2)},
                         device="cpu")
    assert isinstance(tree["w"], torch.Tensor) and tree["w"].device.type == "cpu"
    assert put_variables(None) is None
