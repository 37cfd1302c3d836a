"""Row-sharded and data-parallel serving that keep every kernel.

Counterpart of `atmvfi_tpu/parallel/spatial.py`. There, `jax.shard_map`
runs one per-shard program on each chip with explicit collectives. Here
each shard's program is a Python generator over the port's `Network`
serving methods (`models/network.py`): it yields a request where the
JAX program has a collective and receives the result.

* `Gather(*tensors)`: the shard's rows of each tensor; the executor
  concatenates all shards' rows along H (the all-gather) and hands each
  shard the full tensors on its own device.
* `Replicated(fn, *args)`: work every shard would compute identically
  (the global branch, the shallow head); it runs once per distinct
  device and each shard on that device gets the result.

`run_lockstep` steps the n generators together in one process. It is
the one seam of the schedule: a multi-process executor (one process per
card, NCCL all-gathers) replaces it without touching the per-shard
programs. A device may hold several shards (`make_mesh((1, n),
["cuda:0"] * n)`), which then run in turn on it.

Two schedules:

* `make_dp_forward`: the batch split over the 'data' axis, each shard
  the full single-device forward; no collective.
* `make_spatial_forward`: the rows of one frame pair split over the
  'spatial' axis. Each shard owns h_loc = H / n rows and computes them
  on a slab of its rows plus `margin` rows each side, shifted inward at
  the frame's edges so the slab edge is the image edge (the convs' zero
  padding then keeps its meaning; the rows the convs corrupt at an
  inner slab edge are cropped). Deep cut (default): the conv front per
  slab, the 1/8 and 1/16 token maps gathered, the global branch
  replicated, the local attention and enhancement per 8-row-aligned
  1/8 slab with a 32-row halo (`shard_middle`), the token and
  decoder-input warps per shard as row warps, the decoder and
  refinement per slab. Shallow cut (`deep=False`, and always with the
  ensemble, whose multiscale estimate needs the full frames): the head
  through decoder stage 1 replicated, the scale-0 tail per slab. Warps
  read wherever flows point, so the scale-0 warp sources are gathered
  full frames and the tail warps them with K10 at global coordinates.

`make_deep_shard_sim` runs one shard's deep-cut program alone on one
device (`run_alone`: shape-preserving stand-ins for the collectives),
whose time plus the bytes between devices over a link projects the
frame time of the deep cut (`deep_shard_projection`).
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, List, Sequence

import torch

from atmvfi_tpu_torch.ops.resize import upsample_flow_rows
from atmvfi_tpu_torch.parallel.mesh import DATA_AXIS, SPATIAL_AXIS

span = torch.profiler.record_function


class Gather:
    """A shard's request: all-gather its rows of `tensors` along H."""

    def __init__(self, *tensors: torch.Tensor):
        self.tensors = tensors


class Replicated:
    """A shard's request: fn(*args), the same on every shard."""

    def __init__(self, fn: Callable, *args):
        self.fn, self.args = fn, args


def _gather(reqs: Sequence[Gather], devices: Sequence[torch.device]):
    home = devices[0]
    fulls = []
    with span("gather"):
        for k in range(len(reqs[0].tensors)):
            full = torch.cat([r.tensors[k].to(home) for r in reqs], 1)
            fulls.append({d: full.to(d) for d in set(devices)})
    return [tuple(f[d] for f in fulls) if len(fulls) > 1 else fulls[0][d]
            for d in devices]


def _replicate(reqs: Sequence[Replicated], devices: Sequence[torch.device]):
    done: Dict[torch.device, object] = {}
    with span("replicated"):
        for r, d in zip(reqs, devices):
            if d not in done:
                done[d] = r.fn(*r.args)
    return [done[d] for d in devices]


def run_lockstep(shards: List, devices: Sequence[torch.device]) -> List:
    """Run the per-shard generators together: at each step every shard
    makes the same kind of request, which is served for all of them at
    once. Returns the shards' return values."""
    replies = [None] * len(shards)
    while True:
        reqs, results = [], []
        for g, reply in zip(shards, replies):
            try:
                reqs.append(g.send(reply))
            except StopIteration as stop:
                results.append(stop.value)
        if results:
            if reqs:
                raise RuntimeError("shards left the lockstep: "
                                   f"{len(results)} ended, {len(reqs)} not")
            return results
        kind = type(reqs[0])
        if any(type(r) is not kind for r in reqs):
            raise RuntimeError("shards made different requests at one step")
        if kind is Gather:
            replies = _gather(reqs, devices)
        elif kind is Replicated:
            replies = _replicate(reqs, devices)
        else:
            raise TypeError(f"unknown shard request {kind.__name__}")


def _canon(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _nets_on(net, devices) -> Dict[torch.device, torch.nn.Module]:
    """The network on each distinct device: `net` itself where its
    weights are, a copy elsewhere."""
    home = _canon(next(net.parameters()).device)
    return {d: net if d == home else copy.deepcopy(net).to(d).eval()
            for d in set(devices)}


def _gf_rows_fit(h_slab: int, H: int) -> bool:
    """Whether the bands of `upsample_flow_rows` fit their levels: each
    x2 level keeps +-2 extra rows, and a band may not exceed its level's
    full height."""
    ln2 = h_slab // 2 + 4       # 1/2-res band
    ln1 = ln2 // 2 + 4          # 1/4-res band
    return ln2 <= H // 2 and ln1 <= H // 4


def make_dp_forward(net, mesh, global_motion: bool = True):
    """Batch-split serving forward: [B, H, W, 3] x2 -> I_t [B, H, W, 3]
    f32 in [0, 1] on the first device. B must divide over the 'data'
    axis; each shard runs the whole single-device forward (every kernel)
    on its rows of the batch."""
    devices = [_canon(d) for d in mesh.axis_devices(DATA_AXIS)]
    nets = _nets_on(net, devices)
    n = len(devices)

    @torch.no_grad()
    def forward(im0: torch.Tensor, im1: torch.Tensor) -> torch.Tensor:
        if im0.shape[0] % n:
            raise ValueError(f"batch {im0.shape[0]} must divide over {n} "
                             "'data' shards")
        b = im0.shape[0] // n
        outs = []
        for i, d in enumerate(devices):
            rows = slice(i * b, (i + 1) * b)
            out = nets[d](im0[rows].to(d), im1[rows].to(d),
                          global_motion=global_motion)["I_t"]
            outs.append(torch.clamp(out, 0.0, 1.0).float())
        return torch.cat([o.to(devices[0]) for o in outs], 0)

    return forward


MARGIN = 96  # default slab margin of the row-sharded forward, in rows


def slab_geometry(H: int, h_loc: int, i: int, n: int, margin: int):
    """(s, h_slab, crop) of shard i of n: the slab [s, s + h_slab) in
    full-resolution rows, its own rows plus `margin` rows each side,
    shifted inward at the frame's edges; the shard's own rows start at
    crop inside it. The margin is clamped so h_slab <= H and floored to
    16 rows."""
    m = min(margin, (n - 1) * h_loc, (H - h_loc) // 2)
    m = (m // 16) * 16
    h_slab = h_loc + 2 * m
    s = min(max(i * h_loc - m, 0), H - h_slab)
    return s, h_slab, i * h_loc - s


def _warp_sources(net_i, im0f, im1f, gf0_s, gf1_s, s, h_slab, crop, h_loc,
                  global_motion):
    """The full scale-0 warp sources: the shards' rows of them,
    gathered."""
    p0, p1 = net_i.serving_tail_sources(im0f, im1f, gf0_s, gf1_s, s, h_slab,
                                        global_motion)
    rows = slice(crop, crop + h_loc)
    return (yield Gather(p0[:, rows], p1[:, rows]))


def deep_cut(net_i, im0f, im1f, h_loc: int, i: int, n: int, margin: int,
             global_motion: bool = True, shard_middle: bool = True,
             gather_sources: bool = True):
    """Shard i's program of the deep cut on the full frames (see the
    module doc), a generator of `Gather` / `Replicated` requests that
    returns the shard's I_t rows [1, h_loc, W, 3]. With
    `gather_sources=False` (the one-device simulation) the scale-0 blend
    warps read the slab's own pre-aligned sources from its row 0 instead
    of the gathered full ones: the same work, sources clamped at the
    slab's edges."""
    H = im0f.shape[1]
    s, h_slab, crop = slab_geometry(H, h_loc, i, n, margin)
    with span("front"):
        feat_s, gtok_s = net_i.serving_front(
            im0f[:, s:s + h_slab], im1f[:, s:s + h_slab], global_motion)
    # the shard's own token rows, gathered into the full maps
    c8, h8_loc = crop // 8, h_loc // 8
    if global_motion:
        feat8, gtok = yield Gather(
            feat_s[:, c8:c8 + h8_loc],
            gtok_s[:, crop // 16:(crop + h_loc) // 16])
    else:
        feat8, gtok = (yield Gather(feat_s[:, c8:c8 + h8_loc])), None
    H8, s8, hs8 = H // 8, s // 8, h_slab // 8
    sharded = shard_middle and H8 % 8 == 0
    band = sharded and global_motion and _gf_rows_fit(h_slab, H)
    gf0_s = gf1_s = None
    if sharded:
        if global_motion:
            gf8_0, gf8_1, gf0, gf1 = yield Replicated(
                net_i.serving_middle_flows, gtok, not band)
        # the attention slab: 8-row aligned at 1/8 (the window grid)
        # with a halo that absorbs the shifted windows' wrap
        ha = 32
        a_len = min(-(-(h8_loc + 2 * ha + 8) // 8) * 8, H8)
        a0 = min(max(((i * h8_loc - ha) // 8) * 8, 0), H8 - a_len)
        acrop = i * h8_loc - a0
        with span("middle"):
            if global_motion:
                feat_slab = net_i.serving_middle_align_rows(
                    feat8, gf8_0[:, a0:a0 + a_len],
                    gf8_1[:, a0:a0 + a_len], a0)
            else:
                feat_slab = feat8[:, a0:a0 + a_len]
            enh_s, out_s = net_i.serving_middle_attn(feat_slab)
        enh, out = yield Gather(enh_s[:, acrop:acrop + h8_loc],
                                out_s[:, acrop:acrop + h8_loc])
        with span("middle"):
            dec_slab = net_i.serving_middle_decin_rows(
                enh, out[:, s8:s8 + hs8], s8)
            if band:  # the slab's rows of the full-res global flows
                levels = net_i.cfg.pyramid_level - 1
                gf0_s = upsample_flow_rows(gf8_0, levels, s, h_slab)
                gf1_s = upsample_flow_rows(gf8_1, levels, s, h_slab)
    else:
        dec_in, gf0, gf1 = yield Replicated(
            net_i.serving_middle, feat8, gtok, global_motion)
        dec_slab = dec_in[:, s8:s8 + hs8]
    if global_motion and not band:
        gf0_s, gf1_s = gf0[:, s:s + h_slab], gf1[:, s:s + h_slab]
    if gather_sources:
        p0f, p1f = yield from _warp_sources(net_i, im0f, im1f, gf0_s, gf1_s,
                                            s, h_slab, crop, h_loc,
                                            global_motion)
        row0 = s
    else:
        with span("tail"):
            p0f, p1f = net_i.serving_tail_sources(
                im0f, im1f, gf0_s, gf1_s, s, h_slab, global_motion)
        im0f, im1f, row0 = im0f[:, s:s + h_slab], im1f[:, s:s + h_slab], 0
    with span("tail"):
        return net_i.serving_tail_deep(dec_slab, p0f, p1f, im0f, im1f,
                                       gf0_s, gf1_s, row0, crop, h_loc,
                                       global_motion)


def make_spatial_forward(net, mesh, margin: int = MARGIN,
                         global_motion: bool = True,
                         ensemble_global_motion: bool = False,
                         deep: bool = True, shard_middle: bool = True):
    """Row-sharded serving forward of one frame pair over the 'spatial'
    axis: forward(im0, im1) with frames [1, H, W, 3] -> I_t [1, H, W, 3]
    f32 on the first device. H must divide over the n shards in 8-row
    units (16-row for the deep cut, else the shallow one runs), as the
    pipeline's pad divisor guarantees; margin % 16 == 0 keeps every
    slab on the strided convs' grid."""
    if margin % 16:
        raise ValueError(f"margin {margin} must be a multiple of 16")
    if ensemble_global_motion:
        if not global_motion:
            raise ValueError("the ensemble estimates global motion: it "
                             "needs global_motion=True")
        deep = False
    devices = [_canon(d) for d in mesh.axis_devices(SPATIAL_AXIS)]
    n = len(devices)
    nets = _nets_on(net, devices)

    def shallow(net_i, im0_loc, im1_loc, i):
        im0f, im1f = yield Gather(im0_loc, im1_loc)
        H, h_loc = im0f.shape[1], im0_loc.shape[1]
        feat, skips, gf0, gf1 = yield Replicated(
            net_i.serving_head, im0f, im1f, global_motion,
            ensemble_global_motion)
        s, h_slab, crop = slab_geometry(H, h_loc, i, n, margin)
        feat_slab = feat[:, s // 2:(s + h_slab) // 2]
        skips_slab = [skips[0][:, s // 4:(s + h_slab) // 4],
                      skips[1][:, s // 2:(s + h_slab) // 2]]
        gf0_s = gf1_s = None
        if global_motion:
            gf0_s, gf1_s = gf0[:, s:s + h_slab], gf1[:, s:s + h_slab]
        p0f, p1f = yield from _warp_sources(net_i, im0f, im1f, gf0_s, gf1_s,
                                            s, h_slab, crop, h_loc,
                                            global_motion)
        with span("tail"):
            return net_i.serving_tail(feat_slab, skips_slab, p0f, p1f, im0f,
                                      im1f, gf0_s, gf1_s, s, crop, h_loc,
                                      global_motion)

    def deep_body(net_i, im0_loc, im1_loc, i):
        im0f, im1f = yield Gather(im0_loc, im1_loc)
        return (yield from deep_cut(net_i, im0f, im1f, im0_loc.shape[1], i,
                                    n, margin, global_motion, shard_middle))

    @torch.no_grad()
    def forward(im0: torch.Tensor, im1: torch.Tensor) -> torch.Tensor:
        B, H = im0.shape[:2]
        if B != 1:
            raise ValueError(f"row-sharded serving takes one pair, B = {B}")
        if H % (8 * n):
            raise ValueError(f"H = {H} must divide over {n} spatial shards "
                             "in 8-row units")
        h_loc = H // n
        body = deep_body if deep and h_loc % 16 == 0 else shallow
        rows = [slice(i * h_loc, (i + 1) * h_loc) for i in range(n)]
        shards = [body(nets[d], im0[:, r].float().to(d),
                       im1[:, r].float().to(d), i)
                  for i, (d, r) in enumerate(zip(devices, rows))]
        outs = run_lockstep(shards, devices)
        return torch.cat([o.to(devices[0]) for o in outs], 1).float()

    return forward


def run_alone(program, n: int):
    """Run one shard's program on its own device with shape-preserving
    stand-ins for the collectives: a gather answers with the shard's own
    rows tiled n times, a replicated call runs locally. Returns the
    program's return value."""
    reply = None
    while True:
        try:
            req = program.send(reply)
        except StopIteration as stop:
            return stop.value
        if isinstance(req, Gather):
            tiles = [torch.cat([t] * n, 1) for t in req.tensors]
            reply = tuple(tiles) if len(tiles) > 1 else tiles[0]
        elif isinstance(req, Replicated):
            reply = req.fn(*req.args)
        else:
            raise TypeError(f"unknown shard request {type(req).__name__}")


def make_deep_shard_sim(net, H: int, W: int, n: int):
    """One interior shard's deep-cut program (shard i = 1, or 0 when
    n = 1) on one device: `deep_cut` itself, with global motion and the
    sharded middle at the default margin, driven by `run_alone` (each
    gathered map is the shard's own rows tiled n times) and with the
    scale-0 blend warps reading the slab's own pre-aligned sources (no
    gather: the same work, sources clamped at the slab's edges).
    Returns f(im0, im1) with frames [1, H, W, 3] -> the shard's I_t rows
    [1, H / n, W, 3]: its time is one shard's time per frame; add the
    bytes between devices over a link for a projected fps
    (`deep_shard_projection`). Counterpart of
    `atmvfi_tpu/parallel/spatial.py::make_deep_shard_sim`."""
    h_loc = H // n
    if H % n or h_loc % 16:
        raise ValueError(f"H = {H} must split into {n} shards of a "
                         "multiple of 16 rows")
    i = min(1, n - 1)

    @torch.no_grad()
    def f(im0: torch.Tensor, im1: torch.Tensor) -> torch.Tensor:
        return run_alone(deep_cut(net, im0.float(), im1.float(), h_loc, i, n,
                                  MARGIN, gather_sources=False), n)

    return f


# NVLink 4 of an H100 SXM: 900 GB/s to the other cards of the host, all
# to all, 450 GB/s each way (NVIDIA data sheet). A shard receives its
# gathers at most at the one-way rate.
NVLINK_H100_BYTES_PER_S = 450e9


def deep_shard_projection(shard_ms: float, H: int, W: int, n: int,
                          cfg) -> Dict[str, float]:
    """Projected frame time of the deep cut on n H100 SXM cards: one
    shard's measured ms (`make_deep_shard_sim`) plus the bytes between
    devices (`spatial_ici_bytes_deep` with global motion and the sharded
    middle, tokens in cfg.dtype) over NVLink 4's one-way rate, with
    nothing overlapped."""
    ici = spatial_ici_bytes_deep(H, W, n, cfg.fused_dim, cfg.global_dim,
                                 torch.finfo(cfg.dtype).bits // 8)
    link_ms = ici / NVLINK_H100_BYTES_PER_S * 1e3
    return {"shard_ms": shard_ms, "ici_bytes": ici, "link_ms": link_ms,
            "link_bytes_per_s": NVLINK_H100_BYTES_PER_S,
            "projected_ms": shard_ms + link_ms,
            "projected_fps": 1e3 / (shard_ms + link_ms)}


def spatial_ici_bytes(H: int, W: int, n: int) -> int:
    """Per-frame bytes between devices of the shallow schedule: four
    full-frame f32 gathers (2 inputs + 2 pre-aligned sources), each
    shard contributing (n - 1) / n of the array."""
    per_gather = 3 * H * W * 4
    return int(4 * per_gather * (n - 1) / n)


def spatial_ici_bytes_deep(H: int, W: int, n: int, fused_dim: int,
                           global_dim: int, token_bytes: int = 2,
                           global_motion: bool = True,
                           shard_middle: bool = True) -> int:
    """Per-frame bytes between devices of the deep schedule: the shallow
    schedule's frame gathers plus the 1/8 fused tokens [2, H/8, W/8,
    fused_dim] and, with global motion, the 1/16 global tokens [2, H/16,
    W/16, global_dim] in the working type; the sharded middle adds the
    enhanced features [1, H/8, W/8, 2 * fused_dim] and the f32 5-channel
    motion head."""
    b = spatial_ici_bytes(H, W, n)
    tok = 2 * (H // 8) * (W // 8) * fused_dim * token_bytes
    if global_motion:
        tok += 2 * (H // 16) * (W // 16) * global_dim * token_bytes
    if shard_middle:
        tok += (H // 8) * (W // 8) * (2 * fused_dim * token_bytes + 5 * 4)
    return int(b + tok * (n - 1) / n)
