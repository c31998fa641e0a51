"""Random state dicts in the reference's layout, for the importer's tests
and chip_smoke.py, in place of a published checkpoint: built from a plan
of tools/import_reference_ckpt.py at a port module's shapes, with OIHW
kernels, weight norm (weight_g / weight_v), spectral norm (weight_orig /
weight_u / weight_v) and BatchNorm running statistics.  It imports neither
JAX nor the JAX package, so chip_smoke.py takes it too."""

from typing import Dict

import numpy as np
import torch


def _spectral(w):
    """(weight_u, weight_v) of a reference spectral norm: the top singular
    pair of w flattened (O, I*kh*kw), as its power iteration converges."""
    U, _, Vt = np.linalg.svd(w.reshape(w.shape[0], -1).astype(np.float64),
                             full_matrices=False)
    return U[:, 0], Vt[0]


def random_reference_state_dict(plan, module, rng, *,
                                weight_norm: bool = True) -> Dict[str, torch.Tensor]:
    """A random state dict in the reference's layout for `plan` at the port
    `module`'s shapes (rng a numpy Generator): kernels ~ N(0, 1/fan_in),
    spectral layers where the port's are (u, v its top singular pair, as
    the reference's power iteration converges), BN statistics away from 0
    and 1, and with `weight_norm` the nin layers and every other locally
    masked conv weight-normed (g, v), the others plain."""
    sd = {}

    def put(key, x):
        sd[key] = torch.tensor(np.asarray(x, np.float32))

    for n, (kind, t, m) in enumerate(plan):
        sub = module.get_submodule(m)
        if kind in ("conv", "sn_conv"):
            w = rng.normal(size=tuple(sub.weight.shape)) / np.sqrt(sub.weight[0].numel())
            if kind == "sn_conv" and sub.spectral:
                put(f"{t}.weight_orig", w)
                u, v = _spectral(w)
                put(f"{t}.weight_u", u)
                put(f"{t}.weight_v", v)
            else:
                put(f"{t}.weight", w)
            if sub.bias is not None:
                put(f"{t}.bias", rng.normal(0, 0.1, sub.bias.shape))
        elif kind == "bn":
            c = sub.BatchNorm_0.mean.shape
            put(f"{t}.weight", rng.uniform(0.5, 1.5, c))
            put(f"{t}.bias", rng.normal(0, 0.3, c))
            put(f"{t}.running_mean", rng.normal(0, 0.3, c))
            put(f"{t}.running_var", rng.uniform(0.5, 1.5, c))
        elif kind == "noise_bn":
            noise_sz, c = sub.wg.shape
            for lin in ("gain", "bias"):
                w = rng.normal(size=(c, noise_sz)) / np.sqrt(noise_sz)
                if sub.spectral:
                    put(f"{t}.{lin}.weight_orig", w)
                    u, v = _spectral(w)
                    put(f"{t}.{lin}.weight_u", u)
                    put(f"{t}.{lin}.weight_v", v)
                else:
                    put(f"{t}.{lin}.weight", w)
            put(f"{t}.bn.stored_mean", rng.normal(0, 0.3, c))
            put(f"{t}.bn.stored_var", rng.uniform(0.5, 1.5, c))
        elif kind == "quantize":
            for name in ("embed", "cluster_size", "embed_avg"):
                put(f"{t}.{name}", rng.normal(size=tuple(getattr(sub, name).shape)))
        elif kind == "lmconv":
            k2, cin, cout = sub.weight.shape
            k = int(round(k2 ** 0.5))
            w = rng.normal(size=(cout, cin, k, k)) / np.sqrt(cin * k2)
            if weight_norm and n % 2:
                put(f"{t}.weight_g", rng.uniform(0.5, 1.5, (cout, 1, 1, 1)))
                put(f"{t}.weight_v", w)
            else:
                put(f"{t}.weight", w)
            put(f"{t}.bias", rng.normal(0, 0.1, cout))
            if sub.mask_weight is not None:
                put(f"{t}.mask_weight", rng.normal(0, 0.1, (cout, k2)))
        elif kind == "nin":
            cout, cin = sub.Dense_0.weight.shape
            w = rng.normal(size=(cout, cin)) / np.sqrt(cin)
            if weight_norm:
                put(f"{t}.lin_a.weight_g", rng.uniform(0.5, 1.5, (cout, 1)))
                put(f"{t}.lin_a.weight_v", w)
            else:
                put(f"{t}.lin_a.weight", w)
            put(f"{t}.lin_a.bias", rng.normal(0, 0.1, cout))
        else:
            raise ValueError(kind)
    return sd
