"""Paged-KV decode attention: the CUDA kernel (csrc/paged_decode.cu), its
plain PyTorch version, and the page-pool host ops (port of
ray_tpu/ops/paged_attention.py).

The pages-plus-tail structure is kept as in the reference, so the kernel
signature matches it: during a K-step decode window the page pools
[n_pages, kvh, page, hd] are read-only, new K/V rows go to a small dense
tail [B, kvh, kt, hd], and one merge per window scatters the tail into
the pages.  The merge is an in-place index write on the pool here (the
reference returns a new, donated array).
"""
from __future__ import annotations

import ctypes

import torch

from ray_tpu_torch import _kernels
from ray_tpu_torch.ops import counters

HEAD_DIMS = (32, 64, 128)
GROUP_SIZES = (1, 2, 4, 8)
_P, _I = ctypes.c_void_p, ctypes.c_int
# q, k/v pages, k/v tail, page_table, pos, tail_start, o;
# B, kvh, rep, hd, page, maxp, kt; sm_scale; dtype; stream
_ARGTYPES = [_P] * 9 + [_I] * 7 + [ctypes.c_float, _I, _P]


def paged_decode_reference(q, k_pages, v_pages, k_tail, v_tail,
                           page_table, pos, tail_start, *,
                           sm_scale: float | None = None):
    """Plain version (materializes the gathered KV; small shapes only).

    Admits page rows < tail_start and tail rows tail_start + j <= pos,
    f32 softmax and PV.  A slot with nothing admitted returns zeros (the
    JAX reference would average the masked rows there; no engine state
    reaches that case, since pos >= tail_start always admits tail row 0)."""
    B, kvh, rep, hd = q.shape
    page = k_pages.shape[2]
    kt = k_tail.shape[2]
    maxp = page_table.shape[1]
    if sm_scale is None:
        sm_scale = hd ** -0.5
    idx = page_table.long()
    ks = k_pages[idx].permute(0, 2, 1, 3, 4).reshape(B, kvh, -1, hd)
    vs = v_pages[idx].permute(0, 2, 1, 3, 4).reshape(B, kvh, -1, hd)
    ts = tail_start.long()[:, None, None, None]
    kpos = torch.arange(maxp * page, device=q.device)[None, None, None, :]
    qf = q.float()
    sp = torch.einsum("bhrd,bhkd->bhrk", qf, ks.float()) * sm_scale
    sp = sp.masked_fill(~(kpos < ts), float("-inf"))
    jpos = ts + torch.arange(kt, device=q.device)[None, None, None, :]
    st = torch.einsum("bhrd,bhjd->bhrj", qf, k_tail.float()) * sm_scale
    st = st.masked_fill(~(jpos <= pos.long()[:, None, None, None]),
                        float("-inf"))
    s = torch.cat([sp, st], dim=-1)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    vals = torch.cat([vs.float(), v_tail.float()], dim=2)
    o = torch.einsum("bhrk,bhkd->bhrd", p, vals)
    o = torch.where(l > 0, o / torch.where(l > 0, l, torch.ones_like(l)),
                    torch.zeros_like(o))
    return o.to(q.dtype)


def _check(q, k_pages, v_pages, k_tail, v_tail, page_table, pos,
           tail_start) -> None:
    dev = q.device
    floats = (q, k_pages, v_pages, k_tail, v_tail)
    ints = (page_table, pos, tail_start)
    if any(t.device != dev for t in floats + ints):
        raise ValueError("paged_decode_attention: every input must be on "
                         "one CUDA device")
    if (q.dtype not in _kernels.DTYPE_CODES
            or any(t.dtype != q.dtype for t in floats)):
        raise ValueError("paged_decode_attention takes float32 or bfloat16 "
                         "q/pages/tails of one dtype")
    if any(t.dtype != torch.int32 for t in ints):
        raise ValueError("page_table, pos and tail_start must be int32")
    B, kvh, rep, hd = q.shape
    n_pages, pkvh, page, phd = k_pages.shape
    if (v_pages.shape != k_pages.shape or pkvh != kvh or phd != hd
            or k_tail.shape[:2] != (B, kvh) or k_tail.shape[3] != hd
            or v_tail.shape != k_tail.shape or page_table.dim() != 2
            or page_table.shape[0] != B or pos.shape != (B,)
            or tail_start.shape != (B,)):
        raise ValueError("paged_decode_attention: inconsistent shapes")
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {hd}")
    if rep not in GROUP_SIZES:
        raise ValueError(f"paged kernel takes n_heads / n_kv_heads in "
                         f"{GROUP_SIZES}, got {rep}")
    for t in floats + ints:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("paged_decode_attention: inputs must be "
                             "contiguous and 16-byte aligned")


def paged_decode_attention(q, k_pages, v_pages, k_tail, v_tail,
                           page_table, pos, tail_start, *,
                           sm_scale: float | None = None):
    """Paged + tail decode attention (read-only on every input).

    q:          [B, kvh, rep, hd]   current-token queries (RoPE applied)
    k_pages/v_pages: [n_pages, kvh, page, hd]  shared page pools
                (rows < tail_start; loop-invariant during a window)
    k_tail/v_tail:   [B, kvh, kt, hd]  the window's accumulated rows
                (row j = absolute position tail_start + j; the current
                token's K/V must already be written at pos - tail_start)
    page_table: [B, maxp] int32     page ids per slot (page 0 = trash)
    pos:        [B] int32           current attend position
    tail_start: [B] int32           pos snapshot at window start

    Returns o [B, kvh, rep, hd].  CUDA tensors launch the kernel once
    (counted in `paged_decode_attention.launches`): a cluster of 8 blocks
    per (slot, kv head) splits the slot's admitted keys, which the kernel
    counts on the device from pos and tail_start, so the call never reads
    device state on the host.  CPU tensors take the plain version."""
    if not q.is_cuda:
        return paged_decode_reference(q, k_pages, v_pages, k_tail, v_tail,
                                      page_table, pos, tail_start,
                                      sm_scale=sm_scale)
    _check(q, k_pages, v_pages, k_tail, v_tail, page_table, pos, tail_start)
    B, kvh, rep, hd = q.shape
    if sm_scale is None:
        sm_scale = hd ** -0.5
    o = torch.empty_like(q)
    fn = _kernels.function("paged_decode", "rt_paged_decode", _ARGTYPES)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             k_tail.data_ptr(), v_tail.data_ptr(), page_table.data_ptr(),
             pos.data_ptr(), tail_start.data_ptr(), o.data_ptr(), B, kvh,
             rep, hd, k_pages.shape[2], page_table.shape[1],
             k_tail.shape[2], float(sm_scale),
             _kernels.DTYPE_CODES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _kernels.check(err, "paged_decode_attention")
    counters.count(paged_decode_attention)
    return o


paged_decode_attention.launches = 0


def merge_tail_pages(pages, tail, page_table, tail_start, n_rows):
    """Scatter a finished window's tail rows into the page pool, IN PLACE
    (returns `pages`).

    pages [n_pages, kvh, page, hd]; tail [B, kvh, kt, hd]; row j of slot b
    lands at absolute position tail_start[b] + j for j < n_rows.  Positions
    past a slot's allocation resolve to the trash page via the zeroed
    table columns, and so do rows j >= n_rows, so a short window cannot
    clobber live data with stale tail columns."""
    B, kvh, kt, hd = tail.shape
    page = pages.shape[2]
    maxp = page_table.shape[1]
    j = torch.arange(kt, device=tail.device)[None, :]
    apos = torch.clamp(tail_start.long()[:, None] + j, max=maxp * page - 1)
    pids = torch.gather(page_table.long(), 1, apos // page)
    pids = torch.where(j < n_rows, pids, torch.zeros_like(pids))
    pages[pids, :, apos % page] = tail.permute(0, 2, 1, 3)
    return pages


def gather_pages(pages, page_table):
    """Materialize per-slot dense KV windows from the page pool.

    pages [n_pages, kvh, page, hd] + page_table [B, maxp] ->
    [B, maxp*page, kvh, hd]; rows past a slot's allocation read the trash
    page and are masked by the caller."""
    B, maxp = page_table.shape
    _, kvh, page, hd = pages.shape
    g = pages[page_table.long()]               # [B, maxp, kvh, page, hd]
    return g.permute(0, 1, 3, 2, 4).reshape(B, maxp * page, kvh, hd)
