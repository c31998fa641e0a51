"""K1: the fused PixelCNN forward, the AR sampler's hot path.

Port of pixelsynth_tpu/ops/lmconv_fused.py.  One forward is: the
embedding-gather first layer + PONO (PyTorch), the up pass (K1a: ->
9-entry bf16 skip stack), the down pass (K1b: -> (B, HW, F) f32), and the
512-way nin (PyTorch; `.at` applies it only to the gathered rows).

`up` / `down` launch the hand-written CUDA kernels of
csrc/lmconv_fused.cu (one persistent launch a pass, csrc/lmconv_pass.cuh)
for CUDA tensors and take their plain PyTorch
versions `up_plain` / `down_plain` for CPU tensors.  On the card a pass
the K1 kernel does not take (float32 compute, or a shape it cannot hold:
`k1_route`) runs as the plain version runs it with every masked conv, and
the gated resnets' nin skip as a one-tap conv, a launch of K3
(`up_k3` / `down_k3`).  The plain versions
follow the TPU kernels' formulas step for step: a tap shift is a roll of
the flat (HW, F) activation with wraparound zeroed by the boundary-folded
masks, concat_elu as elu halves (`exp(-|x|) - 1`), PONO as
E[x^2] - mean^2 with ddof=1 (`_pono_dot`), bf16 operands with f32
accumulation, and a bf16 skip stack popped top-first from entry 3*nr+2.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from pixelsynth_tpu_torch.models.layers import pono
from pixelsynth_tpu_torch.ops import _cuda
from pixelsynth_tpu_torch.ops.conv_pack import (
    TILE, pack_taps, prepare_taps, resident_rows_fit, tile_tap_table,
)
from pixelsynth_tpu_torch.ops.masked_conv import locally_masked_embed
from pixelsynth_tpu_torch.ops.masked_conv_kernel import (
    PreparedMask, centre_mask, centre_taps, k3_dtype, k3_layer_conv,
)

# launches of each CUDA kernel, counted by its wrapper, and passes of the
# "k3" route on the card (each a stack of K3 launches, which K3 counts);
# calls that took the plain version (CPU)
LAUNCHES = {"lmconv_up": 0, "lmconv_down": 0, "lmconv_up_k3": 0, "lmconv_down_k3": 0}
PLAIN_CALLS = {"lmconv_up": 0, "lmconv_down": 0}


def _cdt(compute_dtype: str) -> torch.dtype:
    return torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32


def shifts(k: int, dilation: int, W: int):
    half = k // 2
    return [((i - half) * dilation * W + (j - half) * dilation)
            for i in range(k) for j in range(k)]


# the conv weights the CUDA kernel reads as packed images
CONV_WEIGHTS = ("uw1", "uw2", "udw", "dw1", "dws", "dw2", "ddw")


def pack_lmconv_params(params: Dict[str, torch.Tensor], *, nr_resnet: int = 2,
                       compute_dtype: str = "bfloat16",
                       device=None) -> Dict[str, torch.Tensor]:
    """Flax-named PixelCNN arrays (flat "GatedResnet_0/LMConv_0/weight"
    keys) -> stacked weights for the fused forward.  Call once per model.

    Unlike the TPU packing, the concat_elu input halves and the (a, gate)
    output halves stay together: the CUDA kernel reads the halves as one
    K = 2F (and N = 2F) dimension.  Conv weights are cast to the compute
    dtype; biases, the embedding table and the nin stay f32.  In bfloat16
    every conv weight also gets its packed image for the CUDA kernel under
    "<name>_img" (ops/conv_pack.py), made here, once per model, and the
    arrays are checked once for the kernel (`check_packed`)."""
    cdt = _cdt(compute_dtype)
    nr = nr_resnet
    n_up, n_dn = 3 * nr, 3 * nr + 2

    def p(name):
        return torch.as_tensor(params[name], dtype=torch.float32,
                               device=device).contiguous()

    def gw(i, leaf):
        return p(f"GatedResnet_{i}/{leaf}")

    def stack(names, dtype=torch.float32):
        return torch.stack([p(n) if isinstance(n, str) else n
                            for n in names]).to(dtype).contiguous()

    up_r, dn_r = range(n_up), range(n_up, n_up + n_dn)
    packed = {}
    for pre, rng in (("u", up_r), ("d", dn_r)):
        packed[f"{pre}w1"] = stack([gw(i, "LMConv_0/weight") for i in rng], cdt)
        packed[f"{pre}b1"] = stack([gw(i, "LMConv_0/bias") for i in rng])
        packed[f"{pre}w2"] = stack([gw(i, "LMConv_1/weight") for i in rng], cdt)
        packed[f"{pre}b2"] = stack([gw(i, "LMConv_1/bias") for i in rng])
    packed["dws"] = stack([gw(i, "Nin_0/Dense_0/kernel") for i in dn_r], cdt)
    packed["dbs"] = stack([gw(i, "Nin_0/Dense_0/bias") for i in dn_r])
    packed["udw"] = stack([f"LMConv_{1 + i}/weight" for i in range(2)], cdt)
    packed["udb"] = stack([f"LMConv_{1 + i}/bias" for i in range(2)])
    packed["ddw"] = stack([f"LMConv_{3 + i}/weight" for i in range(2)], cdt)
    packed["ddb"] = stack([f"LMConv_{3 + i}/bias" for i in range(2)])
    packed["embed_w"] = p("LMConv_0/weight")
    packed["embed_b"] = p("LMConv_0/bias")
    packed["nin_w"] = p("Nin_0/Dense_0/kernel")
    packed["nin_b"] = p("Nin_0/Dense_0/bias")
    if cdt == torch.bfloat16:
        Fc = packed["uw1"].shape[-1]
        for name in CONV_WEIGHTS:
            w = packed[name]
            packed[f"{name}_img"] = pack_taps(w if w.dim() == 4 else w[:, None], Fc)
        check_packed(packed, nr)
    return packed


def fold_boundary_masks(mask: torch.Tensor, H: int, W: int, k: int,
                        dilation: int) -> torch.Tensor:
    """(B, k2, HW) -> (B, HW, k2) f32 with out-of-image taps zeroed (the
    flat roll / shifted load wraps across rows and images)."""
    half = k // 2
    rows = np.arange(H * W) // W
    cols = np.arange(H * W) % W
    valid = np.ones((H * W, k * k), np.float32)
    for i in range(k):
        for j in range(k):
            dr, dc = (i - half) * dilation, (j - half) * dilation
            valid[:, i * k + j] = ((rows + dr >= 0) & (rows + dr < H)
                                   & (cols + dc >= 0) & (cols + dc < W))
    v = torch.as_tensor(valid, device=mask.device)
    return (mask.float().transpose(1, 2) * v[None]).contiguous()


# ---------------------------------------------------------------------------
# plain versions (the TPU kernels' arithmetic, flat (B, HW, F) layout)
# ---------------------------------------------------------------------------


def _elu_halves(x):
    e = torch.exp(-x.abs()) - 1.0
    return torch.where(x > 0, x, e), torch.where(x < 0, -x, e)


def _pono_dot(x, eps=1e-5):
    Fc = x.shape[-1]
    ones = torch.ones((Fc, 1), dtype=torch.float32, device=x.device)
    s1 = x @ ones
    s2 = (x * x) @ ones
    mean = s1 / Fc
    var = (s2 - Fc * mean * mean) / (Fc - 1)
    return (x - mean) / torch.sqrt(var + eps)


def _dot(x, w, cdt):
    """cdt-rounded operands, f32 accumulation."""
    return x.to(cdt).float() @ w.float()


def _roll(x, s):
    return x if s == 0 else torch.roll(x, -s, dims=1)


def _conv_split(ha, hb, m, w, b, sh, cdt):
    Fc = ha.shape[-1]
    acc = None
    for t, s in enumerate(sh):
        z = _dot(_roll(ha, s), w[t, :Fc], cdt)
        z = z + _dot(_roll(hb, s), w[t, Fc:], cdt)
        z = m[..., t:t + 1] * z
        acc = z if acc is None else acc + z
    return acc + b


def _conv_split_dual(ha, hb, m, w2, b2, sh, cdt):
    Fc = ha.shape[-1]
    acc_a = acc_g = None
    for t, s in enumerate(sh):
        ra, rb = _roll(ha, s), _roll(hb, s)
        za = _dot(ra, w2[t, :Fc, :Fc], cdt) + _dot(rb, w2[t, Fc:, :Fc], cdt)
        zg = _dot(ra, w2[t, :Fc, Fc:], cdt) + _dot(rb, w2[t, Fc:, Fc:], cdt)
        mt = m[..., t:t + 1]
        za, zg = mt * za, mt * zg
        if acc_a is None:
            acc_a, acc_g = za, zg
        else:
            acc_a, acc_g = acc_a + za, acc_g + zg
    return acc_a + b2[:Fc], acc_g + b2[Fc:]


def _conv_single(h, m, w, b, sh, cdt):
    acc = None
    for t, s in enumerate(sh):
        z = m[..., t:t + 1] * _dot(_roll(h, s), w[t], cdt)
        acc = z if acc is None else acc + z
    return acc + b


def _gated(og, a, m, w1, b1, ws, bs, w2, b2, sh, cdt):
    Fc = og.shape[-1]
    xa, xb = _elu_halves(og)
    x = _pono_dot(_conv_split(xa, xb, m, w1, b1, sh, cdt))
    if a is not None:
        aa, ab = _elu_halves(a)
        x = x + (_dot(aa, ws[:Fc], cdt) + _dot(ab, ws[Fc:], cdt)) + bs
    ya, yb = _elu_halves(x)
    z_a, z_g = _conv_split_dual(ya, yb, m, w2, b2, sh, cdt)
    return og + _pono_dot(z_a) * torch.sigmoid(z_g)


def up_plain(u0, mu, md, packed, *, W, nr, dilation, compute_dtype):
    """(B, HW, F) f32 -> skip stack (B, 3nr+3, HW, F) bf16."""
    cdt = _cdt(compute_dtype)
    s1, sd = shifts(3, 1, W), shifts(3, dilation, W)
    u = u0.float()
    out = [u]
    g = 0
    for blk in range(3):
        for _ in range(nr):
            u = _gated(u, None, mu, packed["uw1"][g], packed["ub1"][g], None,
                       None, packed["uw2"][g], packed["ub2"][g], s1, cdt)
            out.append(u)
            g += 1
        if blk < 2:
            u = _pono_dot(_conv_single(u, md, packed["udw"][blk],
                                       packed["udb"][blk], sd, cdt))
            out.append(u)
    return torch.stack(out, dim=1).to(torch.bfloat16)


def down_plain(stack, mu, md, packed, *, W, nr, dilation, compute_dtype):
    """skip stack (B, 3nr+3, HW, F) bf16 -> (B, HW, F) f32."""
    cdt = _cdt(compute_dtype)
    s1, sd = shifts(3, 1, W), shifts(3, dilation, W)
    u = stack[:, 3 * nr + 2].float()
    top = 3 * nr + 1
    g = 0
    for i, n in enumerate((nr, nr + 1, nr + 1)):
        for _ in range(n):
            u = _gated(u, stack[:, top].float(), mu, packed["dw1"][g],
                       packed["db1"][g], packed["dws"][g], packed["dbs"][g],
                       packed["dw2"][g], packed["db2"][g], s1, cdt)
            g += 1
            top -= 1
        if i < 2:
            u = _pono_dot(_conv_single(u, md, packed["ddw"][i],
                                       packed["ddb"][i], sd, cdt))
    return u


# ---------------------------------------------------------------------------
# the "k3" route: a pass whose convs are K3 launches
# ---------------------------------------------------------------------------


def k1_route(H: int, W: int, Fc: int, nr: int, dilation: int,
             compute_dtype: str) -> str:
    """The route of a pass on the card, by dtype and shape alone (never by
    a failure): "fused", the K1 kernel, for bfloat16 compute with
    H*W % 128 == 0, F % 16 == 0 and F <= 80, 1 <= nr <= 4, and a tile's
    rows and halo within the resident rows (`rows_fit`: W <= 44 at F = 80);
    else "k3": `up_k3` / `down_k3`, each conv on K3's kernel of
    `k3_dtype`."""
    if (compute_dtype == "bfloat16" and (H * W) % TILE == 0 and Fc % 16 == 0
            and Fc <= 80 and 1 <= nr <= 4 and rows_fit(W, dilation, Fc)):
        return "fused"
    return "k3"


class K3Masks(NamedTuple):
    """The masks of a "k3" pass in K3's layout: the folded masks of the
    dilation-1 and the dilated convs, and the centre-tap mask of the nin
    skip."""

    mu: PreparedMask
    md: PreparedMask
    centre: PreparedMask


def _prepared(rows: torch.Tensor) -> PreparedMask:
    taps = tile_tap_table(rows) if rows.shape[1] % TILE == 0 else None
    return PreparedMask(rows, rows.transpose(1, 2), taps, {})


def k3_masks(mu: torch.Tensor, md: torch.Tensor) -> K3Masks:
    """Folded masks (B, HW, 9) -> `K3Masks`: a sampling loop makes them once."""
    B, HW, _ = mu.shape
    return K3Masks(_prepared(mu), _prepared(md), centre_mask(B, HW, mu.device))


# the pass's conv weights and their biases
_BIAS = {"uw1": "ub1", "uw2": "ub2", "udw": "udb", "dw1": "db1", "dw2": "db2",
         "ddw": "ddb", "dws": "dbs"}


def _k3_weights(packed: Dict, kernel_dtype: str, compute_dtype: str) -> Dict:
    """{weight name: [(weights, bias) a layer]} as K3 takes them, made once
    per packed dict (kept in it, so a call's checks are cached on the
    masks): PackedTaps for K3's bf16 kernel, f32 (rounded to bf16 for bf16
    compute) for its f32 kernel; the nin skip as centre taps."""
    cache = packed.setdefault("k3_weights", {})
    key = (kernel_dtype, compute_dtype)
    if key not in cache:
        Fc = packed["uw1"].shape[-1]

        def prep(w):
            if kernel_dtype == "bfloat16":
                return prepare_taps(w, Fc)
            w = w.float()
            if compute_dtype == "bfloat16":
                w = w.to(torch.bfloat16).float()
            return w.contiguous()

        cache[key] = {
            name: [(prep(centre_taps(w) if name == "dws" else w), b)
                   for w, b in zip(packed[name], packed[bias].unbind(0))]
            for name, bias in _BIAS.items()}
    return cache[key]


def _k3_conv(packed, masks: K3Masks, *, B, H, W, dilation, compute_dtype):
    """conv(h (B, HW, K) f32, weight name, layer) -> (B, HW, N) f32 through
    K3, with that weight's mask and dilation."""
    Fc = packed["uw1"].shape[-1]
    weights = _k3_weights(packed, k3_dtype(H * W, 2 * Fc, Fc, compute_dtype),
                          compute_dtype)

    def conv(h, name, i):
        if name in ("udw", "ddw"):
            m, d = masks.md, dilation
        else:
            m, d = (masks.centre if name == "dws" else masks.mu), 1
        w, b = weights[name][i]
        y = k3_layer_conv(h.reshape(B, H, W, -1), m, w, b, dilation=d,
                          compute_dtype=compute_dtype)
        return y.reshape(B, H * W, -1)

    return conv


def _gated_k3(og, a, conv, pre, g):
    """`_gated` with K3 convs: the concat_elu halves side by side as one
    K = 2F operand, the dual conv as one N = 2F output."""
    Fc = og.shape[-1]
    x = _pono_dot(conv(torch.cat(_elu_halves(og), -1), f"{pre}w1", g))
    if a is not None:
        x = x + conv(torch.cat(_elu_halves(a), -1), "dws", g)
    z = conv(torch.cat(_elu_halves(x), -1), f"{pre}w2", g)
    return og + _pono_dot(z[..., :Fc]) * torch.sigmoid(z[..., Fc:])


def up_k3(u0, mu, md, packed, *, H, W, nr, dilation, compute_dtype, masks=None):
    """The up pass as `up_plain`, every conv a K3 call.  masks: `k3_masks`
    of (mu, md), made here when not given."""
    conv = _k3_conv(packed, masks or k3_masks(mu, md), B=u0.shape[0], H=H, W=W,
                    dilation=dilation, compute_dtype=compute_dtype)
    u = u0.float()
    out = [u]
    g = 0
    for blk in range(3):
        for _ in range(nr):
            u = _gated_k3(u, None, conv, "u", g)
            out.append(u)
            g += 1
        if blk < 2:
            u = _pono_dot(conv(u, "udw", blk))
            out.append(u)
    return torch.stack(out, dim=1).to(torch.bfloat16)


def down_k3(stack, mu, md, packed, *, H, W, nr, dilation, compute_dtype, masks=None):
    """The down pass as `down_plain`, every conv a K3 call."""
    conv = _k3_conv(packed, masks or k3_masks(mu, md), B=stack.shape[0], H=H, W=W,
                    dilation=dilation, compute_dtype=compute_dtype)
    u = stack[:, 3 * nr + 2].float()
    top = 3 * nr + 1
    g = 0
    for i, n in enumerate((nr, nr + 1, nr + 1)):
        for _ in range(n):
            u = _gated_k3(u, stack[:, top].float(), conv, "d", g)
            g += 1
            top -= 1
        if i < 2:
            u = _pono_dot(conv(u, "ddw", i))
    return u


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_ulonglong


def _lib():
    lib = _cuda.load("lmconv_fused")
    if not getattr(lib, "_typed", False):
        lib.lmconv_fused_up.argtypes = [_P] * 16 + [_I] * 7 + [_U64, _P]
        lib.lmconv_fused_up.restype = _I
        lib.lmconv_fused_down.argtypes = [_P] * 19 + [_I] * 7 + [_U64, _P]
        lib.lmconv_fused_down.restype = _I
        lib.lmconv_fused_groups.argtypes = [_I, _I]
        lib.lmconv_fused_groups.restype = _I
        lib.lmconv_fused_cluster.argtypes = []
        lib.lmconv_fused_cluster.restype = _I
        lib._typed = True
    return lib


def dependency_window(W: int, dilation: int, tile: int = TILE) -> int:
    """Tiles each side of a tile that a layer of a K1 pass reads: the
    largest tap shift of the 3x3 convs (dilation 1 and `dilation`) on a
    width-W grid, in tiles of `tile` flat positions, rounded up.  A block
    of the pass waits for the counters of these tiles before it copies a
    layer's operand rows."""
    reach = max(abs(s) for d in (1, dilation) for s in shifts(3, d, W))
    return -(-reach // tile)


def rows_fit(W: int, dilation: int, Fc: int, tile: int = TILE) -> bool:
    """Whether a tile's rows and both halos fit the pass's resident rows:
    the 3x3 convs on K = 2F channels (dilation 1) and on K = F (dilation
    `dilation`), on a width-W grid."""
    return (resident_rows_fit(W, 1, 2 * Fc, tile)
            and resident_rows_fit(W, dilation, Fc, tile))


def packed_shapes(nr: int, Fc: int):
    """{name: (dtype, shape)} of every array the CUDA passes read from
    `pack_lmconv_params`' output at width Fc (the images flat per layer)."""
    n_up, n_dn = 3 * nr, 3 * nr + 2
    bf, f32 = torch.bfloat16, torch.float32
    out = {}
    for name, dt, shape in (
            ("uw1", bf, (n_up, 9, 2 * Fc, Fc)), ("ub1", f32, (n_up, Fc)),
            ("uw2", bf, (n_up, 9, 2 * Fc, 2 * Fc)), ("ub2", f32, (n_up, 2 * Fc)),
            ("udw", bf, (2, 9, Fc, Fc)), ("udb", f32, (2, Fc)),
            ("dw1", bf, (n_dn, 9, 2 * Fc, Fc)), ("db1", f32, (n_dn, Fc)),
            ("dws", bf, (n_dn, 2 * Fc, Fc)), ("dbs", f32, (n_dn, Fc)),
            ("dw2", bf, (n_dn, 9, 2 * Fc, 2 * Fc)), ("db2", f32, (n_dn, 2 * Fc)),
            ("ddw", bf, (2, 9, Fc, Fc)), ("ddb", f32, (2, Fc))):
        out[name] = (dt, shape)
        if name in CONV_WEIGHTS:
            n = 1
            for d in shape[1:]:
                n *= d
            out[f"{name}_img"] = (bf, (shape[0], n))
    return out


def check_packed(packed: Dict, nr: int) -> int:
    """Raise unless `packed` holds every array the CUDA passes read, in
    bf16 (f32 biases), of one width and on one device, contiguous; returns
    the width.  `pack_lmconv_params` calls it once and records the result
    under "k1_checked", so a call of `up` / `down` does not repeat it."""
    if "uw1" not in packed or packed["uw1"].dim() != 4:
        raise ValueError("K1: packed weights lack uw1 (use pack_lmconv_params)")
    Fc = packed["uw1"].shape[-1]
    dev = packed["uw1"].device
    for name, (dt, shape) in packed_shapes(nr, Fc).items():
        t = packed.get(name)
        if t is None:
            raise ValueError(f"K1: packed weights lack {name}")
        if t.dtype != dt or tuple(t.shape) != shape or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"K1: {name} is {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected contiguous {dt} {shape} on {dev}")
    packed["k1_checked"] = (nr, Fc, str(dev))
    return Fc


class Workspace:
    """Scratch of the K1 passes for one (B, HW, F, device): the bf16
    operands the layers exchange (the f32 activation stays in the blocks'
    shared memory) and the per-(candidate, tile) layer counters (plus one
    grid-wide count), zeroed once when made.  Calls on one stream use it
    in turn; each call takes the next epoch, so the counters never need
    resetting."""

    def __init__(self, B: int, HW: int, Fc: int, device):
        bf = torch.bfloat16
        self.ue = torch.empty((B, HW, 2 * Fc), dtype=bf, device=device)
        self.xe = torch.empty((B, HW, 2 * Fc), dtype=bf, device=device)
        self.ubf = torch.empty((B, HW, Fc), dtype=bf, device=device)
        self.flags = torch.zeros(B * (HW // TILE) + 1, dtype=torch.int64, device=device)
        self.epoch = 0

    def next_epoch(self) -> int:
        self.epoch += 1
        return self.epoch


_WORKSPACES: "OrderedDict[tuple, Workspace]" = OrderedDict()
WORKSPACES_KEPT = 8


def workspace(B: int, HW: int, Fc: int, device) -> Workspace:
    """The cached `Workspace` of (B, HW, Fc, device); the least recently
    used is dropped beyond WORKSPACES_KEPT."""
    key = (B, HW, Fc, str(torch.device(device)))
    ws = _WORKSPACES.pop(key, None)
    if ws is None:
        ws = Workspace(B, HW, Fc, device)
    _WORKSPACES[key] = ws
    while len(_WORKSPACES) > WORKSPACES_KEPT:
        _WORKSPACES.popitem(last=False)
    return ws


# the stamps buffer of an LMK_STAMPS build (tools/profile_k1.py sets it)
STAMPS = {"buffer": None}


def _check_call(x, mu, md, packed, tables, *, H, W, nr):
    """The per-call checks of a K1 launch (`k1_route` has taken its dtype
    and shape): shapes of the activations and masks; the packed weights
    only when not checked yet for this nr."""
    B, HW, Fc = x.shape[0], x.shape[-2], x.shape[-1]
    if HW != H * W:
        raise ValueError(f"K1: {HW} positions for a {H}x{W} grid")
    checked = packed.get("k1_checked")
    if checked is None or checked[0] != nr:
        check_packed(packed, nr)
        checked = packed["k1_checked"]
    if checked[1:] != (Fc, str(x.device)):
        raise ValueError(f"K1: weights of width {checked[1]} on {checked[2]}, "
                         f"input of width {Fc} on {x.device}")
    for m, name in ((mu, "mu"), (md, "md")):
        _cuda.require(m, name, dtype=torch.float32, shape=(B, HW, 9), device=x.device)
    tu, td = tables if tables is not None else tile_tables(mu, md)
    for t, name in ((tu, "tables[0]"), (td, "tables[1]")):
        _cuda.require(t, name, dtype=torch.int32, shape=(B, HW // TILE, 9),
                      device=x.device)
    return B, HW, Fc, tu, td


def tile_tables(mu, md):
    """The (tile, tap) tables of the folded masks mu, md, for `up` / `down`:
    a sampling loop makes them once, beside the masks."""
    return tile_tap_table(mu), tile_tap_table(md)


def _stamps():
    buf = STAMPS["buffer"]
    return _cuda.ptr(buf) if buf is not None else None


def up(u0, mu, md, packed, *, H, W, nr, dilation, compute_dtype="bfloat16",
       tables=None):
    """K1a.  u0 (B, HW, F) f32, mu/md (B, HW, 9) folded masks -> skip stack
    (B, 3nr+3, HW, F) bf16: one launch, or on the "k3" route (`k1_route`)
    a stack of K3 launches.  tables: `tile_tables(mu, md)` for the K1
    kernel, `k3_masks(mu, md)` for the "k3" route; made at this call when
    not given."""
    if not u0.is_cuda:
        PLAIN_CALLS["lmconv_up"] += 1
        return up_plain(u0, mu, md, packed, W=W, nr=nr, dilation=dilation,
                        compute_dtype=compute_dtype)
    if k1_route(H, W, u0.shape[-1], nr, dilation, compute_dtype) == "k3":
        out = up_k3(u0, mu, md, packed, H=H, W=W, nr=nr, dilation=dilation,
                    compute_dtype=compute_dtype,
                    masks=tables if isinstance(tables, K3Masks) else None)
        LAUNCHES["lmconv_up_k3"] += 1
        return out
    B, HW, Fc, tu, td = _check_call(u0, mu, md, packed, tables, H=H, W=W, nr=nr)
    _cuda.require(u0, "u0", dtype=torch.float32, shape=(B, HW, Fc))
    if packed["uw1"].requires_grad or u0.requires_grad:
        raise ValueError("K1 serves inference only: no gradient")
    ws = workspace(B, HW, Fc, u0.device)
    stack = torch.empty((B, 3 * nr + 3, HW, Fc), dtype=torch.bfloat16,
                        device=u0.device)
    P = _cuda.ptr
    rc = _lib().lmconv_fused_up(
        P(u0), P(mu), P(md), P(tu), P(td), P(packed["uw1_img"]),
        P(packed["ub1"]), P(packed["uw2_img"]), P(packed["ub2"]),
        P(packed["udw_img"]), P(packed["udb"]), P(stack), P(ws.ue), P(ws.xe),
        P(ws.flags), _stamps(), B, H, W, Fc, nr, dilation,
        dependency_window(W, dilation), ws.next_epoch(), _cuda.stream_of(u0))
    _cuda.check(rc, "lmconv_fused_up")
    LAUNCHES["lmconv_up"] += 1
    return stack


def down(stack, mu, md, packed, *, H, W, nr, dilation,
         compute_dtype="bfloat16", tables=None):
    """K1b.  skip stack (B, 3nr+3, HW, F) bf16 -> (B, HW, F) f32: one
    launch, or the "k3" route.  tables as for `up`."""
    if not stack.is_cuda:
        PLAIN_CALLS["lmconv_down"] += 1
        return down_plain(stack, mu, md, packed, W=W, nr=nr,
                          dilation=dilation, compute_dtype=compute_dtype)
    if k1_route(H, W, stack.shape[-1], nr, dilation, compute_dtype) == "k3":
        out = down_k3(stack, mu, md, packed, H=H, W=W, nr=nr, dilation=dilation,
                      compute_dtype=compute_dtype,
                      masks=tables if isinstance(tables, K3Masks) else None)
        LAUNCHES["lmconv_down_k3"] += 1
        return out
    B, HW, Fc, tu, td = _check_call(stack, mu, md, packed, tables, H=H, W=W, nr=nr)
    _cuda.require(stack, "stack", dtype=torch.bfloat16,
                  shape=(B, 3 * nr + 3, HW, Fc))
    ws = workspace(B, HW, Fc, stack.device)
    out = torch.empty((B, HW, Fc), dtype=torch.float32, device=stack.device)
    P = _cuda.ptr
    rc = _lib().lmconv_fused_down(
        P(stack), P(mu), P(md), P(tu), P(td), P(packed["dw1_img"]),
        P(packed["db1"]), P(packed["dws_img"]), P(packed["dbs"]),
        P(packed["dw2_img"]), P(packed["db2"]), P(packed["ddw_img"]),
        P(packed["ddb"]), P(out), P(ws.ue), P(ws.xe), P(ws.ubf),
        P(ws.flags), _stamps(), B, H, W, Fc, nr, dilation,
        dependency_window(W, dilation), ws.next_epoch(), _cuda.stream_of(stack))
    _cuda.check(rc, "lmconv_fused_down")
    LAUNCHES["lmconv_down"] += 1
    return out


def resident_candidates(Fc: int, HW: int) -> int:
    """Candidates a K1 pass runs at once on this card (more are rounds of
    the same launch), and the blocks of one cluster: (groups, cluster)."""
    lib = _lib()
    groups = lib.lmconv_fused_groups(Fc, HW)
    if groups < 0:
        _cuda.check(-groups, "lmconv_fused_groups")
    return groups, lib.lmconv_fused_cluster()


# ---------------------------------------------------------------------------
# the forward and the sampler's logits closure
# ---------------------------------------------------------------------------


def embed_input(packed, codes, filled, mask_init, *, num_classes):
    """Embedding-gather first layer + PONO -> (B, HW, F) f32."""
    B, H, W = codes.shape
    u0 = locally_masked_embed(codes, filled, mask_init, packed["embed_w"],
                              packed["embed_b"], num_classes=num_classes)
    return pono(u0).reshape(B, H * W, -1).contiguous()


def pixelcnn_forward_fused(packed, codes, filled, mask_init, mu, md, *, H, W,
                           nr_resnet=2, max_dilation=2, num_classes=512,
                           compute_dtype="bfloat16", return_features=False,
                           tables=None):
    """codes/filled (B, H, W); mask_init (B, k2, HW); mu/md folded
    (B, HW, k2); tables `tile_tables(mu, md)` or None.  Returns
    (B, H, W, num_classes) logits, or the pre-nin features (B, HW, F) f32
    when return_features."""
    B = codes.shape[0]
    kw = dict(H=H, W=W, nr=nr_resnet, dilation=max_dilation,
              compute_dtype=compute_dtype, tables=tables)
    u0 = embed_input(packed, codes, filled, mask_init, num_classes=num_classes)
    u = down(up(u0, mu, md, packed, **kw), mu, md, packed, **kw)
    if return_features:
        return u
    logits = F.elu(u) @ packed["nin_w"] + packed["nin_b"]
    return logits.reshape(B, H, W, num_classes)


def make_fused_logits_fn(packed: Dict, masks: torch.Tensor, *,
                         nr_resnet: int = 2, max_dilation: int = 2,
                         num_classes: int = 512,
                         compute_dtype: str = "bfloat16") -> Callable:
    """masks (B, 3, k2, HW) -> fn(codes, filled) -> logits, with
    fn.at(codes, filled, pos) -> logits at pos (B,) or (B, G) only (elu +
    nin on the gathered rows)."""
    B, _, K2, HW = masks.shape
    k = int(round(K2 ** 0.5))
    side = int(round(HW ** 0.5))
    m_init = masks[:, 0]
    mu = fold_boundary_masks(masks[:, 1], side, side, k, 1)
    md = fold_boundary_masks(masks[:, 2], side, side, k, max_dilation)
    # the route's masks and tables, made once here beside the masks
    tables = None
    if masks.is_cuda:
        route = k1_route(side, side, packed["uw1"].shape[-1], nr_resnet,
                         max_dilation, compute_dtype)
        tables = tile_tables(mu, md) if route == "fused" else k3_masks(mu, md)
    kw = dict(H=side, W=side, nr_resnet=nr_resnet, max_dilation=max_dilation,
              num_classes=num_classes, compute_dtype=compute_dtype,
              tables=tables)

    def fn(codes, filled):
        return pixelcnn_forward_fused(packed, codes, filled, m_init, mu, md, **kw)

    def at(codes, filled, pos):
        u = pixelcnn_forward_fused(packed, codes, filled, m_init, mu, md,
                                   return_features=True, **kw)
        single = pos.dim() == 1
        p2 = pos[:, None] if single else pos
        rows = torch.gather(u, 1, p2.long()[..., None].expand(-1, -1, u.shape[-1]))
        out = F.elu(rows) @ packed["nin_w"] + packed["nin_b"]
        return out[:, 0] if single else out

    fn.at = at
    return fn
