"""Plain fp32 reference of RAFT (Teed & Deng, "RAFT: Recurrent All-Pairs
Field Transforms for Optical Flow", ECCV 2020, arXiv:2003.12039), written
after upstream's own formulation (github.com/princeton-vl/RAFT, ``core/``):

- ``BasicEncoder`` twice: the feature encoder (instance norm, 256 out) over
  both frames and the context encoder (BatchNorm from its running
  statistics, 256 out split into a tanh hidden state and a relu input of
  128 each): conv 7x7/2, three layers of two residual blocks (64, 96/2,
  128/2), conv 1x1;
- ``CorrBlock``: one ``torch.matmul`` volume per pair over sqrt(C), pooled
  by ``F.avg_pool2d`` into ``levels`` levels (an odd side floored), and a
  window of (2r+1)^2 samples per level by ``bilinear_sampler``:
  ``F.grid_sample(..., align_corners=True)`` at 2x/(W-1) - 1, the offsets
  from ``meshgrid(dy, dx)`` used as (x, y), so the x offset is the outer
  index;
- ``BasicUpdateBlock``: the motion encoder, the separable ConvGRU (1x5 then
  5x1), the flow head and the mask head (x 0.25), from zero flow, the
  coordinates moved by each step's delta;
- convex 8x upsampling through a 9-way softmax over the last step's mask.

It runs one pair at a time, with ``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32`` False unless ``tf32`` asks for the
control, in the dtype given (float32 by default). The state dict is the
program's, in upstream's key names; nothing of the program is imported.

Departures from upstream, each for the comparison's sake:
- frames [H, W, 3] uint8 are mapped as upstream's ``2 * (x / 255) - 1`` and
  edge-padded at the bottom and right to multiples of 8, as this pipeline
  pads; upstream's ``InputPadder`` centres the padding. The flow is cropped
  back;
- a pyramid level one wide in a direction is sampled with grid_sample's
  ``align_corners=False`` at (2x + 1)/W - 1, the same pixel coordinate:
  upstream's 2x/(W-1) - 1 divides by zero there (such levels occur only
  below 16 px of feature grid, in the CPU tests, never at 256 px);
- a level whose side would pool below 1 is not built, as the program's
  pyramid stops (upstream raises there);
- ``norm3``, upstream's second registration of a strided block's
  downsample norm, is read as ``downsample.1``, the one module it is.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

HIDDEN = 128


@contextlib.contextmanager
def _precision(tf32: bool):
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _conv(sd, name, x, stride=1, padding=0):
    return F.conv2d(x, sd[name + ".weight"], sd[name + ".bias"], stride=stride, padding=padding)


def _norm(sd, name, x, kind):
    if kind == "instance":
        return F.instance_norm(x, eps=1e-5)
    return F.batch_norm(x, sd[name + ".running_mean"], sd[name + ".running_var"],
                        sd[name + ".weight"], sd[name + ".bias"], training=False, eps=1e-5)


def _block(sd, p, x, kind, stride):
    """Upstream's ResidualBlock."""
    y = F.relu(_norm(sd, p + ".norm1", _conv(sd, p + ".conv1", x, stride, 1), kind))
    y = F.relu(_norm(sd, p + ".norm2", _conv(sd, p + ".conv2", y, 1, 1), kind))
    if stride != 1:
        x = _norm(sd, p + ".downsample.1", _conv(sd, p + ".downsample.0", x, stride), kind)
    return F.relu(x + y)


def encoder(sd, p, x, kind):
    """Upstream's BasicEncoder: [N, 3, H, W] -> [N, 256, H/8, W/8]."""
    x = F.relu(_norm(sd, p + ".norm1", _conv(sd, p + ".conv1", x, 2, 3), kind))
    for layer, stride in ((1, 1), (2, 2), (3, 2)):
        x = _block(sd, f"{p}.layer{layer}.0", x, kind, stride)
        x = _block(sd, f"{p}.layer{layer}.1", x, kind, 1)
    return _conv(sd, p + ".conv2", x)


def _grid(coord, side, corners):
    """A pixel coordinate normalised for grid_sample: upstream's
    2x/(side-1) - 1 for ``align_corners=True``, else (2x+1)/side - 1."""
    return 2 * coord / (side - 1) - 1 if corners else (2 * coord + 1) / side - 1


def bilinear_sampler(img, coords):
    """img [N, 1, h, w]; coords [N, k, k, 2] (x, y) in pixels -> [N, 1, k, k],
    zero outside."""
    h, w = img.shape[-2:]
    corners = h > 1 and w > 1
    grid = torch.stack([_grid(coords[..., 0], w, corners), _grid(coords[..., 1], h, corners)],
                       dim=-1)
    return F.grid_sample(img, grid, align_corners=corners)


class CorrBlock:
    """Upstream's all-pairs correlation volume, its pyramid and lookup."""

    def __init__(self, fmap1, fmap2, levels, radius):
        self.levels, self.radius = levels, radius
        n, c, h, w = fmap1.shape
        corr = torch.matmul(fmap1.view(n, c, h * w).transpose(1, 2), fmap2.view(n, c, h * w))
        corr = corr.reshape(n * h * w, 1, h, w) / torch.sqrt(torch.tensor(float(c)))
        self.pyramid = [corr]
        for _ in range(levels - 1):
            if min(self.pyramid[-1].shape[-2:]) < 2:
                break
            self.pyramid.append(F.avg_pool2d(self.pyramid[-1], 2, stride=2))

    def __call__(self, coords):
        r = self.radius
        coords = coords.permute(0, 2, 3, 1)
        n, h, w, _ = coords.shape
        d = torch.linspace(-r, r, 2 * r + 1, device=coords.device, dtype=coords.dtype)
        delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1)  # (dy, dx) as (x, y)
        out = []
        for i, corr in enumerate(self.pyramid):
            centroid = coords.reshape(n * h * w, 1, 1, 2) / 2 ** i
            sampled = bilinear_sampler(corr, centroid + delta.view(1, 2 * r + 1, 2 * r + 1, 2))
            out.append(sampled.view(n, h, w, -1))
        return torch.cat(out, dim=-1).permute(0, 3, 1, 2).contiguous()


def _gru(sd, h, x):
    """Upstream's SepConvGRU: a 1x5 pass, then a 5x1 pass."""
    for i, pad in ((1, (0, 2)), (2, (2, 0))):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(_conv(sd, f"update_block.gru.convz{i}", hx, padding=pad))
        r = torch.sigmoid(_conv(sd, f"update_block.gru.convr{i}", hx, padding=pad))
        q = torch.tanh(_conv(sd, f"update_block.gru.convq{i}", torch.cat([r * h, x], dim=1),
                             padding=pad))
        h = (1 - z) * h + z * q
    return h


def update_block(sd, net, inp, corr, flow):
    """Upstream's BasicUpdateBlock: (net, delta flow, mask)."""
    e = "update_block.encoder."
    c = F.relu(_conv(sd, e + "convc2", F.relu(_conv(sd, e + "convc1", corr)), padding=1))
    f = F.relu(_conv(sd, e + "convf2", F.relu(_conv(sd, e + "convf1", flow, padding=3)),
                     padding=1))
    motion = torch.cat([F.relu(_conv(sd, e + "conv", torch.cat([c, f], dim=1), padding=1)),
                        flow], dim=1)
    net = _gru(sd, net, torch.cat([inp, motion], dim=1))
    delta = _conv(sd, "update_block.flow_head.conv2",
                  F.relu(_conv(sd, "update_block.flow_head.conv1", net, padding=1)), padding=1)
    mask = _conv(sd, "update_block.mask.2",
                 F.relu(_conv(sd, "update_block.mask.0", net, padding=1)))
    return net, delta, 0.25 * mask


def upsample_flow(flow, mask):
    """Upstream's convex upsampling: [N, 2, H, W] -> [N, 2, 8H, 8W]."""
    n, _, h, w = flow.shape
    mask = torch.softmax(mask.view(n, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).view(n, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(n, 2, 8 * h, 8 * w)


def raft(sd, image1, image2, iters, levels=4, radius=4):
    """Upstream's RAFT.forward in test mode: images [1, 3, H, W] in [-1, 1],
    H and W multiples of 8 -> the upsampled flow [1, 2, H, W]."""
    fmap1, fmap2 = encoder(sd, "fnet", torch.cat([image1, image2]), "instance").split(1)
    corr_fn = CorrBlock(fmap1, fmap2, levels, radius)
    cnet = encoder(sd, "cnet", image1, "batch")
    net, inp = torch.tanh(cnet[:, :HIDDEN]), torch.relu(cnet[:, HIDDEN:])
    n, _, h, w = fmap1.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=fmap1.device, dtype=fmap1.dtype),
                            torch.arange(w, device=fmap1.device, dtype=fmap1.dtype),
                            indexing="ij")
    coords0 = torch.stack([xs, ys])[None].expand(n, 2, h, w)
    coords1 = coords0.clone()
    mask = None
    for _ in range(iters):
        corr = corr_fn(coords1)
        net, delta, mask = update_block(sd, net, inp, corr, coords1 - coords0)
        coords1 = coords1 + delta
    return upsample_flow(coords1 - coords0, mask)


def flows(sd, frames1, frames2, iters, levels=4, radius=4, tf32=False, dtype=torch.float32):
    """Frames [P, H, W, 3] uint8 (a tensor on the device the state dict is
    on) -> flows [P, H, W, 2] float32, one pair at a time."""
    sd = {k: v.to(dtype) if v.is_floating_point() else v for k, v in sd.items()}
    H, W = frames1.shape[1:3]
    pad = (0, (-W) % 8, 0, (-H) % 8)  # bottom and right, as the pipeline pads
    out = []
    with torch.no_grad(), _precision(tf32):
        for a, b in zip(frames1, frames2):
            img = [F.pad(2 * (t.permute(2, 0, 1)[None].to(dtype) / 255.0) - 1.0, pad,
                         mode="replicate") for t in (a, b)]
            flow = raft(sd, *img, iters, levels, radius)
            out.append(flow[0, :, :H, :W].permute(1, 2, 0).float())
    return torch.stack(out)
