"""The detection pipeline: RGB images -> BoardResult (port of
img2sgf_tpu/pipeline/detect.py, img2sgf.py:117-204, 497-576).

Entry points: detect_board (one image, native size or a canvas with
content_hw), detect_board_auto (one image padded into its canvas bucket),
detect_board_batch ([B, H, W, 3] of one size) and detect_board_bucket_batch
(canvases of one bucket holding images of mixed native sizes). All run the
same four stages over a batch, one image being a batch of one: pre
(preprocess, grey, outer Canny of the whole batch in one hysteresis call,
blur pyramid), plane state (internal Canny, walk steps, cascade accumulator
over the pool of every image's unique planes), select (proposals,
exact-vote rescore, recentre and ring, compaction, radius histogram,
finalize, and one rerun of the saturated planes of every image at the
overflow budgets), post (erasure, Hough lines, clustering, grid validation,
classification, alignment: one pass of [B, ...] tensor code, the
counterpart of the JAX package's jax.vmap(_post_circles), which reads
nothing back to the host).

The overflow rerun has the JAX package's form: the saturated planes are
sorted first (a stable argsort), and the big-budget selection runs over
fixed chunks of _overflow_chunk(P) planes, only on the chunks that hold a
saturated plane, its results taken with where(sat, big, base). Where the
JAX package's lax.map/lax.cond decides on the device, the port reads the P
saturation flags back once (through pinned memory and an event): the one
host read of a call, and none when the config turns the rerun off.

The stages run in three segments, _segment_select (pre, plane state, base
selection), _segment_chunk (the rerun of one chunk) and _segment_post
(merge, post), which read nothing back to the host, so that a CUDA graph
can capture each one (pipeline/graphs.py, the counterpart of jax.jit). On a
card, detect_board_jit, detect_board_auto, detect_board_batch and
detect_board_bucket_batch replay such graphs, one set per shape and config;
detect_board, and any call given timings=, runs the segments eagerly, as
every call on the CPU does.

Content dims (the shape-bucketed mode): a canvas whose top-left [h, w]
block is the real image gives, inside that block, the results of detection
at native size (every op emulates its OpenCV border inside the canvas and
masks its output to the block), except where the JAX package itself
differs and the port follows it: the Gaussian blur at a canvas margin of
1-2 px (ops/blur.py) and the contrast mean at an exact .5 (ops/color.py).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any

import numpy as np
import torch

from ..config import DetectionConfig
from ..core.board import align_board
from ..grid.cluster import cluster_1d
from ..grid.complete import validate_grid
from ..grid.identify import identify_board
from ..hough.circles import (
    _stable_argsort,
    circle_candidates,
    circle_finalize,
    circle_plane_state_pool,
    propose_from_acc,
    radius_support_pool,
)
from ..hough.erase import erase_circles
from ..hough.lines import hough_lines_intercepts
from ..ops.blur import blur_pyramid
from ..ops.canny import canny_rgb_pool
from ..ops.color import grey_bgr_quirk, preprocess


@dataclasses.dataclass
class BoardResult:
    """Pipeline output: tensors with the JAX package's BoardResult fields."""

    board_ready: Any  # bool: grid valid and fits the board
    valid_grid: Any  # bool
    full_board: Any  # [19,19] int32 BoardStates (LEFT/TOP aligned)
    detected_board: Any  # [19,19] int32, top-left hsize x vsize block
    hsize: Any
    vsize: Any
    side_to_move: Any  # 1 black / 2 white
    num_black: Any
    num_white: Any
    circles: Any  # [C,3] all raw circles from every variant
    circles_valid: Any
    circles_filtered_valid: Any  # after the size filter (img2sgf.py:439-443)
    hlines: Any  # [L] y-intercepts of detected horizontal lines
    hlines_valid: Any
    vlines: Any
    vlines_valid: Any
    hcentres: Any  # [M] cluster centres (+inf padded)
    hcount: Any
    vcentres: Any
    vcount: Any
    hcentres_complete: Any
    vcentres_complete: Any
    hspace: Any
    vspace: Any
    hreason: Any  # grid rejection reason codes (grid.complete)
    vreason: Any
    hdiag: Any  # [6] narration diagnostics per axis
    vdiag: Any
    intensities: Any  # [19,19] mean window intensity per grid point
    stone_mask: Any  # [19,19] bool
    grey: Any  # [H,W] uint8 processed grey image
    edges: Any  # [H,W] uint8 Canny edges
    circles_removed: Any  # [H,W] uint8 edge map after erasure


def _variant_dedup(cfg: DetectionConfig, V: int):
    """Identity-blur dedup: median/Gaussian at ksize 1 equal the grey
    variant, so detection runs on unique planes and outputs are replicated."""
    if cfg.maxblur >= 0 and V >= 4:
        keep = [0, 1] + list(range(4, V))
        expand = [0, 1, 0, 0] + list(range(2, 2 + V - 4))
    else:
        keep = list(range(V))
        expand = keep
    return keep, expand


def _take(x, idx):
    """x[:, idx] for a static index list, as slices of its runs of
    consecutive indices: no index tensor is uploaded to the device."""
    runs = []
    for i in idx:
        if runs and runs[-1][1] == i:
            runs[-1][1] = i + 1
        else:
            runs.append([i, i + 1])
    if runs == [[0, x.shape[1]]]:
        return x
    return torch.cat([x[:, a:b] for a, b in runs], dim=1)


def _pre_circles(rgb_u8, cfg: DetectionConfig, hw=None):
    """Preprocess through the blur pyramid (img2sgf.py:142-175) of a
    [B, H, W, 3] batch, whose outer Canny is one shared hysteresis run
    (canny_rgb_pool). hw=(hs, ws): [B] content dims. Returns (grey [B, H, W],
    outer Canny edges [B, H, W], variants [B, V, H, W])."""
    rgb = preprocess(rgb_u8, cfg.contrast, cfg.brightness, hw=hw)
    grey = grey_bgr_quirk(rgb)
    edges = canny_rgb_pool(rgb, cfg.edge_min, cfg.edge_max, cfg.gradient_l2,
                           iters=cfg.hysteresis_iters, hw_batch=hw)
    variants = blur_pyramid(grey, edges, cfg.maxblur, hw=hw)
    return grey, edges, variants


def _plane_state_pool(planes, cfg: DetectionConfig, hw_planes=None):
    """Budget-independent circle state of a [P, H, W] plane pool: internal
    Canny, walk steps and the accumulator (circle_plane_state_pool; the
    cascade, or the per-offset accumulator for a radius span not divisible
    by 5). hw_planes=(hs, ws): [P] content dims. Returns dict(emask, sx, sy,
    acc), plus hs and ws with hw_planes: the state carries its planes'
    content dims into the selection stages."""
    st = circle_plane_state_pool(
        planes, cfg.circle_canny_high, cfg.circle_min_radius,
        cfg.circle_max_radius, cfg.num_angle_bins,
        hysteresis_iters=cfg.hysteresis_iters, hw_planes=hw_planes)
    if hw_planes is not None:
        st["hs"], st["ws"] = hw_planes
    return st


def _select_candidates(st, cfg: DetectionConfig, top_k: int | None = None,
                       prov_budget: int | None = None,
                       peak_budget: int | None = None,
                       dedupe_first: bool = False,
                       margin_filter: bool = False):
    """Proposals and exact candidates from plane state: the inputs of the
    radius stage, bounded by the state's content dims if it has them.
    Returns (ys_c, xs_c, valid2 [P, peak_budget], sat [P]): sat flags
    planes where a capacity truncated candidates."""
    H, W = st["acc"].shape[-2], st["acc"].shape[-1]
    hw = (st["hs"], st["ws"]) if "hs" in st else None
    top_k = cfg.max_center_candidates if top_k is None else top_k
    prov_budget = cfg.max_ring_candidates if prov_budget is None else prov_budget
    peak_budget = cfg.max_peak_candidates if peak_budget is None else peak_budget
    sel_floor = None
    if margin_filter and cfg.carrier_floor_factor is not None:
        sel_floor = cfg.carrier_floor_factor * cfg.circle_acc_threshold
    ys, xs, pvalid, psat = propose_from_acc(
        st["acc"], cfg.circle_acc_threshold, top_k,
        threshold_factor=cfg.propose_threshold_factor,
        margin_factor=cfg.overflow_margin_factor,
        select_floor=sel_floor, hw=hw, block=cfg.propose_block,
    )
    ys_c, xs_c, _votes, valid2, ring_sat = circle_candidates(
        st["emask"], st["sx"], st["sy"], ys, xs, pvalid,
        cfg.circle_min_radius, cfg.circle_max_radius,
        cfg.circle_acc_threshold, H, W, prov_budget=prov_budget,
        peak_budget=peak_budget, dedupe_first=dedupe_first, hw=hw,
    )
    return ys_c, xs_c, valid2, psat | ring_sat


def _circles_from_state(st, cfg: DetectionConfig, **budgets):
    """Budget-dependent circle selection from plane state (the keyword
    arguments of _select_candidates). Returns (circles [P, max_out, 3],
    valid [P, max_out], sat [P])."""
    ys_c, xs_c, valid2, sat = _select_candidates(st, cfg, **budgets)
    r_best, support = radius_support_pool(
        st["emask"], ys_c, xs_c, valid2, cfg.circle_min_radius,
        cfg.circle_max_radius)
    circles, valid = circle_finalize(
        ys_c, xs_c, valid2, r_best, support, cfg.circle_acc_threshold,
        cfg.circle_min_dist, cfg.max_circles_per_variant,
        packed_sort=cfg.circle_max_radius <= 44,
    )
    return circles, valid, sat


def _overflow_budgets(cfg: DetectionConfig):
    """The selection arguments of the overflow rerun: the big budgets, with
    dedupe_first (the big pass has no further rerun)."""
    return dict(
        top_k=cfg.overflow_center_candidates,
        prov_budget=max(cfg.overflow_ring_candidates, cfg.max_ring_candidates),
        peak_budget=max(cfg.overflow_peak_candidates, cfg.max_peak_candidates),
        dedupe_first=True, margin_filter=True)


def _overflow_on(cfg: DetectionConfig) -> bool:
    """Whether the config runs the saturation-gated overflow rerun."""
    return cfg.overflow_center_candidates > cfg.max_center_candidates


def _overflow_chunk(P: int) -> int:
    """Planes per chunk of the overflow rerun, as the JAX package chooses
    them: a small divisor of P (4 at P = 8 and at P = 128)."""
    for c in (4, 6, 8, 2, 16, 1):
        if c <= P and P % c == 0:
            return c
    return P


@dataclasses.dataclass
class _Pooled:
    """The selection of a plane pool between the segments of a call: the
    plane state, the base results, and with the overflow rerun the
    saturation flags sat [P], the planes in rerun order (saturated first)
    and the buffers big_c, big_v that the chunks write."""

    st: dict
    circles: Any
    valid: Any
    sat: Any = None
    order: Any = None
    big_c: Any = None
    big_v: Any = None

    @property
    def chunk(self) -> int:
        return _overflow_chunk(self.circles.shape[0])


def _select_base(st, cfg: DetectionConfig) -> _Pooled:
    """The base selection of every plane. With the overflow rerun off the
    base pass is final and uses the vote-ordered unique-peak compaction
    (dedupe_first), as in the JAX package."""
    if not _overflow_on(cfg):
        circles, valid, _ = _circles_from_state(
            st, cfg, dedupe_first=True, margin_filter=True)
        return _Pooled(st, circles, valid)
    circles, valid, sat = _circles_from_state(st, cfg, margin_filter=True)
    return _Pooled(st, circles, valid, sat, _stable_argsort(~sat),
                   torch.zeros_like(circles), torch.zeros_like(valid))


# host reads of saturation flags (_chunks_to_run), added to under _reads_lock
flag_reads = 0
_reads_lock = threading.Lock()


def _chunks_to_run(pooled: _Pooled, flags=None) -> int:
    """How many chunks of the rerun order hold a saturated plane: the
    first ceil(n_sat / chunk). The call's one host read, of the P flags
    (through pinned memory, the buffer flags if given, and an event on a
    card); none with the rerun off."""
    global flag_reads
    if pooled.sat is None:
        return 0
    sat = pooled.sat
    if sat.is_cuda:
        buf = flags
        if buf is None:
            buf = torch.empty(sat.shape, dtype=torch.bool, pin_memory=True)
        buf.copy_(sat, non_blocking=True)
        torch.cuda.current_stream(sat.device).record_event().synchronize()
        sat = buf
    with _reads_lock:
        flag_reads += 1
    return -(-int(sat.sum()) // pooled.chunk)


def _segment_chunk(pooled: _Pooled, idx, cfg: DetectionConfig) -> None:
    """The overflow rerun of one chunk: the big-budget selection
    (_overflow_budgets) of the planes idx (a [chunk] int64 tensor on the
    pool's device) from their gathered plane state, written into
    pooled.big_c and pooled.big_v at those planes. Reads nothing back to
    the host."""
    sub = {k: v.index_select(0, idx) for k, v in pooled.st.items()}
    c, v, _ = _circles_from_state(sub, cfg, **_overflow_budgets(cfg))
    pooled.big_c.index_copy_(0, idx, c)
    pooled.big_v.index_copy_(0, idx, v)


def _run_chunks(pooled: _Pooled, cfg: DetectionConfig) -> None:
    """The eager overflow rerun: every chunk that holds a saturated plane."""
    rp = pooled.chunk
    for c in range(_chunks_to_run(pooled)):
        _segment_chunk(pooled, pooled.order[c * rp:(c + 1) * rp], cfg)


def _merge(pooled: _Pooled):
    """(circles, valid) of every plane: the rerun's results on the
    saturated planes, the base ones elsewhere."""
    if pooled.sat is None:
        return pooled.circles, pooled.valid
    return (torch.where(pooled.sat[:, None, None], pooled.big_c,
                        pooled.circles),
            torch.where(pooled.sat[:, None], pooled.big_v, pooled.valid))


def _circles_pooled(st, cfg: DetectionConfig):
    """Selection with the saturation-gated overflow rerun: base budgets for
    every plane, then the chunks that hold a saturated plane again at the
    overflow budgets, whose results replace the base ones on the saturated
    planes. Takes the plane state (_plane_state_pool), which both passes
    share. Returns (circles [P, max_out, 3], valid [P, max_out])."""
    pooled = _select_base(st, cfg)
    _run_chunks(pooled, cfg)
    return _merge(pooled)


def _post_circles(grey, edges, circles, circles_valid, cfg: DetectionConfig,
                  line_thresholds, hw=None) -> BoardResult:
    """Erasure through board assembly (img2sgf.py:188-198, 230-576) of a
    batch in one pass, the counterpart of the JAX package's
    jax.vmap(_post_circles): grey, edges [B, H, W] uint8, circles [B, C, 3],
    circles_valid [B, C], line_thresholds [B] float32, hw None or (hs, ws)
    [B] int content dims inside a fixed canvas, all on one device. Returns a
    BoardResult with a leading [B] on every field. Every stage is tensor
    code over the batch, and none reads a value back to the host."""
    removed = erase_circles(edges, circles, circles_valid, hw=hw)
    hvals, hvalid, _ = hough_lines_intercepts(
        removed, line_thresholds, True, cfg.angle_delta, cfg.max_lines)
    vvals, vlvalid, _ = hough_lines_intercepts(
        removed, line_thresholds, False, cfg.angle_delta, cfg.max_lines)
    hcentres, hcount = cluster_1d(hvals, hvalid, cfg.min_grid_spacing,
                                  cfg.max_grid_lines)
    vcentres, vcount = cluster_1d(vvals, vlvalid, cfg.min_grid_spacing,
                                  cfg.max_grid_lines)
    grid = validate_grid(hcentres, hcount, vcentres, vcount, cfg.board_size,
                         cfg.min_grid_spacing, cfg.big_space_ratio)
    valid = grid["valid"]

    # circle size filter (img2sgf.py:439-443), strict inequalities
    min_cs = (torch.minimum(grid["hspace"], grid["vspace"]) * 0.3)[:, None]
    max_cs = (torch.maximum(grid["hspace"], grid["vspace"]) * 0.65)[:, None]
    cf_valid = circles_valid & (circles[..., 2] > min_cs) \
        & (circles[..., 2] < max_cs)
    cf_valid = cf_valid & valid[:, None]

    fits = valid & (grid["hsize"] <= cfg.board_size) \
        & (grid["vsize"] <= cfg.board_size)
    ident = identify_board(grey, circles, cf_valid, grid,
                           cfg.black_stone_threshold, cfg.board_size, hw=hw)
    detected = torch.where(fits[:, None, None], ident["detected_board"], 0)
    full = align_board(detected, grid["hsize"], grid["vsize"], False, False,
                       cfg.board_size)
    return BoardResult(
        board_ready=fits,
        valid_grid=valid,
        full_board=full,
        detected_board=detected,
        hsize=grid["hsize"],
        vsize=grid["vsize"],
        side_to_move=torch.where(fits, ident["side_to_move"], 1),
        num_black=torch.where(fits, ident["num_black"], 0),
        num_white=torch.where(fits, ident["num_white"], 0),
        circles=circles,
        circles_valid=circles_valid,
        circles_filtered_valid=cf_valid,
        hlines=hvals,
        hlines_valid=hvalid,
        vlines=vvals,
        vlines_valid=vlvalid,
        hcentres=hcentres,
        hcount=hcount,
        vcentres=vcentres,
        vcount=vcount,
        hcentres_complete=grid["hcentres_complete"],
        vcentres_complete=grid["vcentres_complete"],
        hspace=grid["hspace"],
        vspace=grid["vspace"],
        hreason=grid["hreason"],
        vreason=grid["vreason"],
        hdiag=grid["hdiag"],
        vdiag=grid["vdiag"],
        intensities=ident["intensities"],
        stone_mask=ident["stone_mask"],
        grey=grey,
        edges=edges,
        circles_removed=removed,
    )


def _no_mark(name: str) -> None:
    pass


@dataclasses.dataclass
class _Selected:
    """What _segment_select leaves for the other segments: the batch's grey
    images and outer edges, the pooled selection, and the variant expansion
    of _variant_dedup."""

    grey: Any
    edges: Any
    pooled: _Pooled
    expand: list


def _segment_select(rgb, cfg: DetectionConfig, hw=None,
                    mark=_no_mark) -> _Selected:
    """Pre, plane state and base selection of rgb [B, H, W, 3] uint8 (hw:
    None or [B] int64 content dims, on rgb's device). Reads nothing back to
    the host. mark(stage) is called after "pre" and "state"."""
    B, H, W = rgb.shape[:3]
    grey, edges, variants = _pre_circles(rgb, cfg, hw)
    keep, expand = _variant_dedup(cfg, variants.shape[1])
    Vu = len(keep)
    planes = _take(variants, keep).reshape(B * Vu, H, W)
    hwp = None if hw is None else tuple(v[:, None].expand(B, Vu).reshape(-1)
                                        for v in hw)
    mark("pre")
    st = _plane_state_pool(planes, cfg, hwp)
    mark("state")
    return _Selected(grey, edges, _select_base(st, cfg), expand)


def _segment_post(sel: _Selected, cfg: DetectionConfig, line_thresholds,
                  hw=None, mark=_no_mark) -> BoardResult:
    """Merge of the rerun, variant expansion and the post stage: the
    BoardResult with a leading [B]. Reads nothing back to the host.
    mark(stage) is called after "select" and "post"."""
    circles, valid = _merge(sel.pooled)
    B = sel.grey.shape[0]
    Vu = circles.shape[0] // B
    vcircles = _take(circles.reshape(B, Vu, -1, 3), sel.expand).reshape(B, -1, 3)
    vvalid = _take(valid.reshape(B, Vu, -1), sel.expand).reshape(B, -1)
    mark("select")
    res = _post_circles(sel.grey, sel.edges, vcircles, vvalid, cfg,
                        line_thresholds, hw)
    mark("post")
    return res


def _to_device(t, dev: torch.device):
    """t on dev. A host tensor goes to a card through pinned memory, so the
    copy makes the host wait for nothing."""
    if dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device must exist (no fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() "
                           "is False")
    return dev


def _as_images(x, dev: torch.device, ndim: int, what: str):
    """uint8 images (numpy array or tensor) of `ndim` dims ending in 3
    channels, on dev (_to_device)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if x.dtype != torch.uint8 or x.ndim != ndim or x.shape[-1] != 3:
        raise ValueError(f"expected {what} uint8, got {tuple(x.shape)} "
                         f"{x.dtype}")
    return _to_device(x, dev)


def _thresholds(line_thresholds, B: int):
    """Line thresholds, checked on the host, as a [B] float32 tensor."""
    ths = torch.as_tensor(line_thresholds).reshape(-1).tolist()
    if len(ths) != B:
        raise ValueError(f"expected {B} line thresholds, got {len(ths)}")
    return torch.tensor(ths, dtype=torch.float32)


def _content_dims(hs, ws, B: int, H: int, W: int):
    """Content dims, checked on the host to be B ints in [1, H] and [1, W],
    as two [B] int64 tensors."""
    hs = [int(v) for v in torch.as_tensor(hs).reshape(-1).tolist()]
    ws = [int(v) for v in torch.as_tensor(ws).reshape(-1).tolist()]
    if len(hs) != B or len(ws) != B:
        raise ValueError(f"expected {B} content dims, got {len(hs)} and "
                         f"{len(ws)}")
    bad = [(h, w) for h, w in zip(hs, ws) if not (1 <= h <= H and 1 <= w <= W)]
    if bad:
        raise ValueError(f"content dims {bad} do not fit the {H}x{W} canvas")
    return (torch.tensor(hs, dtype=torch.int64),
            torch.tensor(ws, dtype=torch.int64))


def _detect_batch_impl(rgb, cfg: DetectionConfig, line_thresholds, hw,
                       timings: dict | None) -> BoardResult:
    """The segments over rgb [B, H, W, 3] uint8 on its device, eagerly,
    each stage once for the whole batch: _segment_select, the overflow
    rerun's chunks (_run_chunks, the call's one host read), _segment_post.
    line_thresholds: [B] float32 (_thresholds); hw: None or (hs, ws), [B]
    int64 (_content_dims); both on the host or on rgb's device. Returns the
    BoardResult with a leading [B] on every field.

    timings: if a dict is given, the device is synchronised after each
    stage and the stage wall times (seconds) are stored under "pre",
    "state", "select" and "post"."""
    dev = rgb.device
    mark = _no_mark
    if timings is not None:
        t = time.perf_counter()

        def mark(name):
            nonlocal t
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            timings[name] = now - t
            t = now

    ths = _to_device(line_thresholds, dev)
    hwb = None if hw is None else tuple(_to_device(v, dev) for v in hw)
    sel = _segment_select(rgb, cfg, hwb, mark)
    _run_chunks(sel.pooled, cfg)
    return _segment_post(sel, cfg, ths, hwb, mark)


def _detect_batch(rgb, cfg: DetectionConfig, line_thresholds, hw,
                  timings: dict | None) -> BoardResult:
    """_detect_batch_impl's result, from the graphs of pipeline/graphs.py
    for a batch on a card (one set per shape, config and stream, captured
    at first use and replayed), eagerly on the CPU or with timings."""
    if rgb.is_cuda and timings is None:
        from . import graphs

        return graphs.run(rgb, cfg, line_thresholds, hw)
    return _detect_batch_impl(rgb, cfg, line_thresholds, hw, timings)


def _row(res: BoardResult, i: int) -> BoardResult:
    """Row i of a batched BoardResult (views of its tensors)."""
    return BoardResult(**{f.name: getattr(res, f.name)[i]
                          for f in dataclasses.fields(BoardResult)})


@torch.no_grad()
def detect_board(rgb_u8, cfg: DetectionConfig, line_threshold=None,
                 content_hw=None, *, device="cuda",
                 timings: dict | None = None) -> BoardResult:
    """Detect a board in rgb_u8 ([H, W, 3] uint8 numpy array or tensor) on
    `device`. line_threshold defaults to cfg.line_threshold; the CLI passes
    choose_line_threshold(h, w).

    content_hw=(h, w): shape-bucketed mode; rgb_u8 is a canvas whose
    top-left [h, w] block is the real image, and the results inside that
    block are those of native-size detection (see the module docstring).

    Runs eagerly, as the JAX package's detect_board is not jitted;
    detect_board_jit is its compiled form.

    timings: per-stage wall times, as _detect_batch_impl stores them.
    """
    dev = resolve_device(device)
    if line_threshold is None:
        line_threshold = cfg.line_threshold
    rgb = _as_images(rgb_u8, dev, 3, "[H, W, 3]")
    hw = None
    if content_hw is not None:
        hw = _content_dims([content_hw[0]], [content_hw[1]], 1, *rgb.shape[:2])
    ths = _thresholds([line_threshold], 1)
    return _row(_detect_batch_impl(rgb[None], cfg, ths, hw, timings), 0)


@torch.no_grad()
def detect_board_jit(rgb_u8, cfg: DetectionConfig, line_threshold, *,
                     device="cuda") -> BoardResult:
    """detect_board of one [H, W, 3] image at native size from its CUDA
    graphs on a card (captured at the first call of each shape and config,
    replayed after), the counterpart of the JAX package's detect_board_jit;
    on the CPU, eagerly."""
    dev = resolve_device(device)
    rgb = _as_images(rgb_u8, dev, 3, "[H, W, 3]")
    ths = _thresholds([line_threshold], 1)
    return _row(_detect_batch(rgb[None], cfg, ths, None, None), 0)


# canvas-size ladder of the shape-bucketed path, as in the JAX package: one
# canvas per bucket instead of one per image shape (the batch path groups
# mixed sizes by it); ratios ~1.25 bound the padding to < 2x the area
_BUCKETS = (128, 160, 192, 256, 320, 384, 512, 640, 768, 960, 1280, 1600, 2048)


def bucket_dim(n: int) -> int:
    """Smallest ladder canvas dim >= n (multiples of 512 beyond the ladder)."""
    for b in _BUCKETS:
        if n <= b:
            return b
    return -(-n // 512) * 512


@torch.no_grad()
def detect_board_auto(rgb_u8, cfg: DetectionConfig, line_threshold=None, *,
                      device="cuda", timings: dict | None = None) -> BoardResult:
    """One [h, w, 3] image through the shape-bucketed path: padded
    top-left into its bucket_dim canvas, detected with content_hw, and the
    image-plane fields (grey, edges, circles_removed) cropped back to
    [h, w]. On a card it replays the bucket's CUDA graphs (one set per
    canvas and config); with timings= it runs eagerly (see
    _detect_batch_impl)."""
    dev = resolve_device(device)
    if line_threshold is None:
        line_threshold = cfg.line_threshold
    rgb = _as_images(rgb_u8, dev, 3, "[h, w, 3]")
    h, w = rgb.shape[:2]
    Hc, Wc = bucket_dim(h), bucket_dim(w)
    canvas = torch.zeros((1, Hc, Wc, 3), dtype=torch.uint8, device=dev)
    canvas[0, :h, :w] = rgb
    hw = _content_dims([h], [w], 1, Hc, Wc)
    ths = _thresholds([line_threshold], 1)
    res = _row(_detect_batch(canvas, cfg, ths, hw, timings), 0)
    return dataclasses.replace(res, grey=res.grey[:h, :w],
                               edges=res.edges[:h, :w],
                               circles_removed=res.circles_removed[:h, :w])


@torch.no_grad()
def detect_board_batch(rgb_u8_batch, cfg: DetectionConfig, line_thresholds, *,
                       device="cuda", timings: dict | None = None) -> BoardResult:
    """Detection over a [B, H, W, 3] uint8 batch of one size at native size;
    line_thresholds: B values. Every BoardResult field has a leading [B].
    On a card it replays the CUDA graphs of (B, H, W, cfg); with timings=
    it runs eagerly."""
    dev = resolve_device(device)
    rgb = _as_images(rgb_u8_batch, dev, 4, "[B, H, W, 3]")
    ths = _thresholds(line_thresholds, rgb.shape[0])
    return _detect_batch(rgb, cfg, ths, None, timings)


@torch.no_grad()
def detect_board_bucket_batch(canvases, cfg: DetectionConfig, line_thresholds,
                              hs, ws, *, device="cuda",
                              timings: dict | None = None) -> BoardResult:
    """Batched shape-bucketed detection: [B, Hc, Wc, 3] canvases whose
    top-left [hs[i], ws[i]] blocks are the real images (mixed native sizes
    in one bucket, the CLI's --batch path). Row i equals detect_board_auto
    of image i; image-plane fields stay canvas-sized, as in the JAX
    package. On a card it replays the CUDA graphs of (B, Hc, Wc, cfg); with
    timings= it runs eagerly."""
    dev = resolve_device(device)
    rgb = _as_images(canvases, dev, 4, "[B, Hc, Wc, 3]")
    B, H, W = rgb.shape[:3]
    ths = _thresholds(line_thresholds, B)
    hw = _content_dims(hs, ws, B, H, W)
    return _detect_batch(rgb, cfg, ths, hw, timings)
