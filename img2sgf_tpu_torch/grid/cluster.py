"""1-D single-linkage clustering of line intercepts (port of
img2sgf_tpu/grid/cluster.py): sort, split where the gap to the previous
point is >= threshold, centres are member means."""

from __future__ import annotations

import torch


def cluster_1d(values, valid, threshold: float, max_clusters: int):
    """values: [..., N] f32 (unsorted, padded), valid: [..., N] bool; the
    leading dims are a batch. Returns (centres [..., max_clusters] f32
    ascending, +inf padded; count [...] i32)."""
    inf = float("inf")
    n = valid.sum(dim=-1, dtype=torch.int32)
    v = torch.sort(torch.where(valid, values, inf), dim=-1).values
    idx = torch.arange(v.shape[-1], device=v.device)
    is_valid = idx < n[..., None]
    prev = torch.cat([v[..., :1], v[..., :-1]], dim=-1)
    brk = (v - prev >= threshold) & is_valid & (idx > 0)
    seg = torch.cumsum(brk.to(torch.int64), dim=-1)
    seg = torch.where(is_valid, seg, max_clusters).clamp(max=max_clusters)
    # member sums are exact in any order: intercepts are multiples of 0.5
    # well below 2^22
    shape = v.shape[:-1] + (max_clusters + 1,)
    sums = torch.zeros(shape, dtype=torch.float32, device=v.device)
    sums.scatter_add_(-1, seg, torch.where(is_valid, v, 0.0))
    counts = torch.zeros(shape, dtype=torch.float32, device=v.device)
    counts.scatter_add_(-1, seg, is_valid.to(torch.float32))
    sums, counts = sums[..., :max_clusters], counts[..., :max_clusters]
    centres = torch.where(counts > 0, sums / counts.clamp(min=1.0), inf)
    ccount = (counts > 0).sum(dim=-1, dtype=torch.int32)
    # reference behaviour: <2 samples -> clustering fails -> no centres
    few = n < 2
    ccount = torch.where(few, 0, ccount)
    centres = torch.where(few[..., None], inf, centres)
    return centres, ccount
