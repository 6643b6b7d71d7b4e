"""Sequence-parallel joint img+txt attention: Ulysses x ring over
torch.distributed (JAX counterpart: parallel/sp_attention.py; reference:
xfuser's xFuserLongContextAttention, hyvideo/modules/attenion.py:159-212,
hyvideo/inference.py:80-83).

* Ulysses: `all_to_all_single` on the ulysses group turns the image q/k/v
  from sequence-sharded [B, S/sp, H, D] into head-sharded [B, S/r, H/u, D]
  (head scatter / sequence gather); the output goes back the same way. The
  text heads are sliced locally and the text output is all-gathered over
  ulysses.
* Ring: the image K/V shards rotate around the ring group, one
  `batch_isend_irecv` pair a hop; each hop folds one shard into a partial
  softmax state, merged by `merge_flash_states`. The state comes from K1/K2
  ("flash") or B8a/B8b ("flash_int8", the keys smoothed by one mean over
  the whole ring); "sdpa" and "chunked" fold the hops in plain PyTorch.
* Joint text, "rear" strategy: the text tokens are replicated; each rank
  folds its heads' text K/V into the state exactly once.
* Ring x STA: a t-slab halo exchange instead of rotation
  (`ring_sta_halo`).

Each rank's local compute between two collectives is a function of its own
(`ulysses_local_attention`, `ring_first_hop` / `ring_hop`,
`halo_slab_attention`, `halo_text_state` / `halo_text_finish`), so a check
can run one rank's arithmetic on one device. The kernels are those of the
single-device path: K1/K2 and B8a/B8b (with `return_state` on the ring),
B4.

Training differentiates all of it. Each collective is an autograd.Function
whose backward is its adjoint (JAX's transposes under shard_map): the
Ulysses all_to_all's is the reverse all_to_all, an all_gather's (the text
heads, the halo's ring states) the reduce-scatter of the peers'
cotangents, a ring send's the send back by the negated offset, all the
tensors of one call in one batch_isend_irecv. The text stream is computed
on every rank and takes a cotangent only through this rank's head slice,
so summing the ranks' gradients (training.py) is exact. The ring hops'
state under grad is `flash_attention_state` (K1 forward, the plain chunked
transpose backward); B5f/B5q/B5kv serve each Ulysses head group.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..ops.attention import joint_attention, resolve_auto_mode
from ..ops.flash_attention import (flash_attention, flash_attention_int8,
                                   flash_attention_state, merge_flash_states)
from .mesh import SPGroups, check_backend

NEG_INF = -1e30


# --------------------------------------------------------------------------
# collectives: each an autograd.Function whose backward is its adjoint
# --------------------------------------------------------------------------

def _all_to_all(send: torch.Tensor, group) -> torch.Tensor:
    """all_to_all_single of `send` [n, ...] (row i to the group's rank i)."""
    send = send.contiguous()
    check_backend(group, send)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv


def _scatter_raw(x, g):
    u = g.u
    b, s, h, d = x.shape
    send = x.reshape(b, s, u, h // u, d).permute(2, 0, 1, 3, 4)
    recv = _all_to_all(send, g.ulysses)
    return recv.permute(1, 0, 2, 3, 4).reshape(b, u * s, h // u, d)


def _unscatter_raw(out, g):
    u = g.u
    b, su, hd = out.shape
    send = out.reshape(b, u, su // u, hd).transpose(0, 1)
    recv = _all_to_all(send, g.ulysses)
    return recv.permute(1, 2, 0, 3).reshape(b, su // u, u * hd)


def _gather_raw(x, group, n):
    """[n, *x.shape]: every rank's x in group order."""
    x = x.contiguous()
    check_backend(group, x)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts)


def _reduce_scatter_raw(parts, group):
    """The adjoint of `_gather_raw`: parts [n, ...] (this rank's cotangent
    of every rank's x) -> the sum over ranks of their cotangents of this
    rank's x, added in group order (an all_to_all, then a sum)."""
    return _all_to_all(parts, group).sum(dim=0)


def _send_recv_raw(sends, g):
    r, j = g.r, g.ring_index
    ops, outs = [], []
    for tag, (x, off) in enumerate(sends):
        x = x.contiguous()
        check_backend(g.ring, x)
        o = torch.empty_like(x)
        ops.append(dist.P2POp(dist.isend, x, g.ring_ranks[(j + off) % r],
                              group=g.ring, tag=tag))
        ops.append(dist.P2POp(dist.irecv, o, g.ring_ranks[(j - off) % r],
                              group=g.ring, tag=tag))
        outs.append(o)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _UlyssesScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g, ctx.shape = g, x.shape
        return _scatter_raw(x, g)

    @staticmethod
    def backward(ctx, gy):
        b, su, hl, d = gy.shape
        return (_unscatter_raw(gy.reshape(b, su, hl * d), ctx.g)
                .reshape(ctx.shape), None)


class _UlyssesUnscatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, g):
        ctx.g, ctx.hd = g, out.shape[-1]
        return _unscatter_raw(out, g)

    @staticmethod
    def backward(ctx, gy):
        # the u head groups as u "heads" of the group's width Hl*D
        b, s, _ = gy.shape
        x = _scatter_raw(gy.reshape(b, s, -1, ctx.hd), ctx.g)
        return x.reshape(b, x.shape[1], ctx.hd), None


class _Gather(torch.autograd.Function):
    """all_gather over `group`; backward the reduce-scatter (each rank's x
    feeds every rank, so its cotangent is the sum of theirs)."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group = group
        return _gather_raw(x, group, n)

    @staticmethod
    def backward(ctx, gy):
        return _reduce_scatter_raw(gy, ctx.group), None, None


class _SendRecv(torch.autograd.Function):
    """One batch_isend_irecv for every (tensor, offset); backward sends each
    cotangent back to where its tensor came from (offset -off), again in
    one batch, so every rank issues its p2p in one order both ways."""

    @staticmethod
    def forward(ctx, g, offs, *xs):
        ctx.g, ctx.offs = g, offs
        return tuple(_send_recv_raw(list(zip(xs, offs)), g))

    @staticmethod
    def backward(ctx, *gys):    # unused outputs' cotangents come as zeros
        back = _send_recv_raw([(gy, -off) for gy, off in zip(gys, ctx.offs)],
                              ctx.g)
        return (None, None, *back)


def ulysses_scatter(x: torch.Tensor, g: SPGroups) -> torch.Tensor:
    """[B, S, H, D] sequence shard -> [B, u*S, H/u, D]: this rank's head
    group over the u shards of its ring index, in ulysses order (one
    all_to_all; backward `ulysses_unscatter`'s)."""
    return _UlyssesScatter.apply(x, g)


def ulysses_unscatter(out: torch.Tensor, g: SPGroups) -> torch.Tensor:
    """[B, u*S, Hl*D] head-group output -> [B, S, H*D] sequence shard (one
    all_to_all; backward `ulysses_scatter`'s)."""
    return _UlyssesUnscatter.apply(out, g)


def ulysses_gather_heads(x: torch.Tensor, g: SPGroups) -> torch.Tensor:
    """[B, L, Hl*D] -> [B, L, H*D], head groups in ulysses order (an
    all_gather; backward the reduce-scatter of the peers' cotangents)."""
    parts = _Gather.apply(x, g.ulysses, g.u)
    return parts.permute(1, 2, 0, 3).reshape(
        x.shape[0], x.shape[1], g.u * x.shape[2])


def ring_send_recv(sends: Sequence[Tuple[torch.Tensor, int]],
                   g: SPGroups) -> List[torch.Tensor]:
    """Each (tensor, offset) goes to ring index j + offset and a tensor of
    its shape comes from j - offset; one batch_isend_irecv for all (the
    tags keep messages to one peer apart). Differentiable: the cotangents
    travel back by one batch_isend_irecv."""
    xs, offs = zip(*sends)
    return list(_SendRecv.apply(g, tuple(offs), *xs))


def _gather_ring(x: torch.Tensor, g: SPGroups) -> List[torch.Tensor]:
    """Every ring rank's x, in ring order (an all_gather; backward the
    reduce-scatter)."""
    return list(_Gather.apply(x, g.ring, g.r).unbind(0))


# --------------------------------------------------------------------------
# one rank's arithmetic
# --------------------------------------------------------------------------

def ulysses_local_attention(img_q, img_k, img_v, txt_q, txt_k, txt_v,
                            txt_bias, *, mode: str, scale: float,
                            bound_mode: str = "auto", score_bound=None,
                            token_grid=None, sta_tile=(4, 8, 8),
                            sta_window=(3, 3, 3), plain: bool = False):
    """The ring-free path's local work: the single-device joint attention
    (K1, K2, B8a/B8b or B4) over the gathered sequence for this rank's
    head group. Under STA `token_grid` is the GLOBAL patch grid."""
    s_r = img_q.shape[1]
    if mode.startswith("sta"):
        if token_grid is None:
            raise ValueError("attn_mode='sta' under Ulysses requires the "
                             "global token_grid")
        if math.prod(token_grid) != s_r:
            raise ValueError(
                f"gathered sequence length {s_r} != prod(token_grid "
                f"{tuple(token_grid)}) — pass the GLOBAL patch grid")
    return joint_attention(img_q, img_k, img_v, txt_q, txt_k, txt_v,
                           txt_bias, mode=mode, scale=scale,
                           bound_mode=bound_mode, score_bound=score_bound,
                           token_grid=token_grid, sta_tile=sta_tile,
                           sta_window=sta_window, plain=plain)


def _wants_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _plain_state(q, k, v, key_bias, scale):
    """(out [B, Sq, H*D], m, l [B, Sq, H]) of the plain running-max
    recurrence: the differentiable state of a call without a static
    bound."""
    b, sq, h, d = q.shape
    bias = (key_bias.reshape(b, 1, 1, -1) if key_bias is not None
            else None)
    m, l, acc = _partial_attn(q, k, v, bias, _init_state(b, h, sq, d,
                                                         q.device), scale)
    return (_finish((m, l, acc), q.dtype), m.transpose(1, 2),
            l.transpose(1, 2))


def _flash_state(q, k, v, key_bias, scale, bound_mode, score_bound, *,
                 mode: str = "flash", key_mean=None, plain: bool = False):
    """(out, m, l) of one call over a key set: K1/K2, or under "flash_int8"
    B8a/B8b on the keys less `key_mean` (plain: their plain version).
    Under grad: K1 through `flash_attention_state` (static bound), else
    the plain recurrence; "flash_int8" has no backward and raises."""
    grad = _wants_grad(q, k, v)
    if mode == "flash_int8":
        if grad:
            raise NotImplementedError(
                "attention mode 'flash_int8' is inference only: it has no "
                "backward (train with 'flash', 'sta' or 'sdpa')")
        return flash_attention_int8(
            q, k, v, key_bias=key_bias, scale=scale,
            bound_mode="static" if bound_mode == "static" else "running",
            score_bound=score_bound, plain=plain, key_mean=key_mean,
            return_state=True)
    if grad and bound_mode == "static":
        return flash_attention_state(q, k, v, key_bias, scale, score_bound)
    if grad:
        return _plain_state(q, k, v, key_bias, scale)
    return flash_attention(q, k, v, key_bias=key_bias, scale=scale,
                           bound_mode=bound_mode, score_bound=score_bound,
                           return_state=True)


def ring_key_mean(img_k, txt_k, g: SPGroups) -> torch.Tensor:
    """The fp32 mean [B, 1, Hl, D] of every key of the joint sequence, the
    ring's image shards and the text: the one mean "flash_int8" smooths
    every hop's keys by (one all_reduce over the ring)."""
    tot = img_k.float().sum(1, keepdim=True).contiguous()
    check_backend(g.ring, tot)
    dist.all_reduce(tot, group=g.ring)
    n = img_k.shape[1] * g.r + txt_k.shape[1]
    return (tot + txt_k.float().sum(1, keepdim=True)) / n


def ring_first_hop(q, img_k, img_v, txt_k, txt_v, txt_bias, *, scale: float,
                   bound_mode: str = "auto", score_bound=None,
                   mode: str = "flash", key_mean=None, plain: bool = False):
    """Ring hop 0: the [img | txt] queries over the local image keys and the
    replicated text keys, with the padding bias, in one call with state
    (`mode` "flash" or "flash_int8", whose keys are smoothed by the ring's
    `key_mean`). Returns (out [B, Sq, Hl*D], m, l)."""
    b, s_r = img_k.shape[:2]
    lt = txt_k.shape[1]
    kb = torch.zeros((b, s_r + lt), dtype=torch.float32, device=q.device)
    if txt_bias is not None:
        kb[:, s_r:] = txt_bias.reshape(b, lt).float()
    return _flash_state(q, torch.cat([img_k, txt_k], 1),
                        torch.cat([img_v, txt_v], 1), kb, scale, bound_mode,
                        score_bound, mode=mode, key_mean=key_mean,
                        plain=plain)


def ring_hop(state, q, k_blk, v_blk, *, scale: float,
             bound_mode: str = "auto", score_bound=None, mode: str = "flash",
             key_mean=None, plain: bool = False):
    """One later ring hop: the queries over a rotated image K/V shard,
    merged into `state`. Each hop's state carries its own offset m, so the
    merge is exact; under "flash_int8" every hop subtracts the same key
    mean, so the per-query constant it adds is the same in every state."""
    return merge_flash_states(state, _flash_state(
        q, k_blk, v_blk, None, scale, bound_mode, score_bound, mode=mode,
        key_mean=key_mean, plain=plain))


def _init_state(b, h, sq, d, device):
    return (torch.full((b, h, sq), NEG_INF, device=device),
            torch.zeros((b, h, sq), device=device),
            torch.zeros((b, h, sq, d), device=device))


def _partial_attn(q, k, v, bias, state, scale, k_chunk: int = 2048):
    """Fold one K/V chunk [B, Sk, Hl, D] (bias [B, 1, 1, Sk] or None) into
    the fp32 online-softmax state (m, l, acc), `k_chunk` keys at a time:
    the streaming recurrence of the modes without a state kernel."""
    m, l, acc = state
    qf = q.float().transpose(1, 2) * scale
    for k0 in range(0, k.shape[1], k_chunk):
        kf = k[:, k0:k0 + k_chunk].float().transpose(1, 2)
        vf = v[:, k0:k0 + k_chunk].float().transpose(1, 2)
        s = torch.matmul(qf, kf.transpose(-1, -2))
        if bias is not None:
            s = s + bias[..., k0:k0 + k_chunk].float()
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(p, vf)
        m = m_new
    return m, l, acc


def _finish(state, dtype):
    m, l, acc = state
    out = acc / l.clamp_min(1e-37)[..., None]
    b, h, sq, d = out.shape
    return out.transpose(1, 2).reshape(b, sq, h * d).to(dtype)


def halo_key_bias(b: int, halo_s: int, s_loc: int, ring_index: int, r: int,
                  device) -> torch.Tensor:
    """[B, halo + S_loc + halo] fp32 image-key bias of an extended slab:
    NEG_INF over the halo that wrapped around the ring's ends (the first
    rank's leading and the last rank's trailing halo), 0 elsewhere."""
    kb = torch.zeros((b, 2 * halo_s + s_loc), device=device)
    if ring_index == 0:
        kb[:, :halo_s] = NEG_INF
    if ring_index == r - 1:
        kb[:, halo_s + s_loc:] = NEG_INF
    return kb


def halo_slab_attention(q_e, k_e, v_e, txt_q, txt_k, txt_v, txt_bias,
                        key_bias, *, grid_ext, halo_s: int, s_loc: int,
                        tile, window, scale: float, bound_mode: str,
                        qk_int8: bool = False, score_bound=None,
                        plain: bool = False):
    """The image queries of one ring rank under STA: `sta_joint_attention`
    (B4, or B4q; plain: their plain version) on the halo-extended slab
    `grid_ext` with the wrap masked by `key_bias`; returns the local rows
    [B, S_loc, Hl*D] (the halo queries' outputs are discarded). Under grad
    its backward is the plain gathered form's (the trainable wrapper)."""
    from ..ops.sta import sta_joint_attention_trainable

    img_out, _ = sta_joint_attention_trainable(
        q_e, k_e, v_e, txt_q, txt_k, txt_v, txt_bias, grid=tuple(grid_ext),
        tile=tuple(tile), window=tuple(window), scale=scale,
        bound_mode=bound_mode, qk_int8=qk_int8, img_key_bias=key_bias,
        score_bound=score_bound, plain=plain)
    return img_out[:, halo_s:halo_s + s_loc]


def halo_text_state(txt_q, img_k, img_v, *, scale: float,
                    bound_mode: str = "auto", score_bound=None):
    """The text queries' partial softmax state over this rank's own
    (halo-free) image keys."""
    return _flash_state(txt_q, img_k, img_v, None, scale, bound_mode,
                        score_bound)


def halo_text_finish(states, txt_q, txt_k, txt_v, txt_bias, *, scale: float,
                     bound_mode: str = "auto", score_bound=None):
    """The text queries' output: the ring's partial states (ring order)
    merged, then the text keys' state folded exactly once."""
    st = states[0]
    for s in states[1:]:
        st = merge_flash_states(st, s)
    st_txt = _flash_state(txt_q, txt_k, txt_v, txt_bias, scale, bound_mode,
                          score_bound)
    return merge_flash_states(st, st_txt)[0]


def ring_sta_halo(img_q, img_k, img_v, txt_q, txt_k, txt_v, txt_bias,
                  g: SPGroups, *, scale: float, attn_mode: str, token_grid,
                  sta_tile, sta_window, bound_mode: str, score_bound=None,
                  plain: bool = False):
    """Sliding Tile Attention across ring shards by a t-slab halo exchange
    (JAX sp_attention.py:105-183). Each ring rank holds a contiguous
    global t-slab; a query tile's window reaches at most wt//2 tile slabs
    beyond it, so one exchange each way of the (wt//2)*tt boundary
    t-planes builds an extended slab on which the single-device STA
    computes every local query's whole window. The edge ranks' wrapped
    halo is masked with NEG_INF, which reproduces the global clipping. The
    text queries need all image keys: partial states over the local keys,
    all-gathered over the ring and merged, then the text keys' state."""
    b, s_loc = img_q.shape[:2]
    r = g.r
    t, hh, ww = token_grid
    tt, wt = sta_tile[0], sta_window[0]
    halo_p = (wt // 2) * tt
    halo_s = halo_p * hh * ww
    grid_ext = (t // r + 2 * halo_p, hh, ww)
    kw = dict(scale=scale, bound_mode=bound_mode, score_bound=score_bound)
    if halo_p:
        xs = (img_q, img_k, img_v)
        got = ring_send_recv([(x[:, -halo_s:], 1) for x in xs]
                             + [(x[:, :halo_s], -1) for x in xs], g)
        q_e, k_e, v_e = (torch.cat([got[i], x, got[3 + i]], 1)
                         for i, x in enumerate(xs))
        kb = halo_key_bias(b, halo_s, s_loc, g.ring_index, r, img_q.device)
    else:
        q_e, k_e, v_e, kb = img_q, img_k, img_v, None
    img_out = halo_slab_attention(
        q_e, k_e, v_e, txt_q, txt_k, txt_v, txt_bias, kb, grid_ext=grid_ext,
        halo_s=halo_s, s_loc=s_loc, tile=sta_tile, window=sta_window,
        qk_int8=attn_mode.endswith("int8"), plain=plain, **kw)
    o, m, l = halo_text_state(txt_q, img_k, img_v, **kw)
    states = list(zip(_gather_ring(o, g), _gather_ring(m, g),
                      _gather_ring(l, g)))
    txt_out = halo_text_finish(states, txt_q, txt_k, txt_v, txt_bias, **kw)
    return img_out.to(img_q.dtype), txt_out.to(img_q.dtype)


# --------------------------------------------------------------------------
# the dispatch
# --------------------------------------------------------------------------

def usp_joint_attention(
    img_q: torch.Tensor,      # [B, S_loc, H, D] sequence-sharded
    img_k: torch.Tensor,
    img_v: torch.Tensor,
    txt_q: torch.Tensor,      # [B, Lt, H, D] replicated
    txt_k: torch.Tensor,
    txt_v: torch.Tensor,
    txt_bias: Optional[torch.Tensor],   # [B, 1, 1, Lt]
    groups: SPGroups,
    scale: Optional[float] = None,
    attn_mode: str = "auto",
    bound_mode: str = "auto",
    score_bound=None,
    token_grid: Optional[Tuple[int, int, int]] = None,
    sta_tile: Tuple[int, int, int] = (4, 8, 8),
    sta_window: Tuple[int, int, int] = (3, 3, 3),
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (img_out [B, S_loc, H*D] sequence-sharded, txt_out
    [B, Lt, H*D] replicated) on every rank of the sp group.

    Without a ring the single-device dispatch runs on the gathered
    sequence for the local heads, any mode (STA needs the global
    `token_grid`, whose product must be the gathered length). With a ring:
    "flash" (and "auto" where it resolves to flash) and "flash_int8" run
    their kernels with state a hop; STA the halo exchange; "sdpa" and
    "chunked" the streaming recurrence in plain PyTorch. `plain` routes
    flash_int8 and the STA image queries to their plain versions, as on
    one device. A score_bound per head ([..., H]) is cut to the rank's
    head group.

    Differentiable (training, JAX training.py:58-61): every collective's
    backward is its adjoint; under grad the static-bound ring hops run
    `flash_attention_state` (K1 forward, plain chunked backward), a
    running-bound "flash" ring takes the plain recurrence, the ring-free
    path `flash_attention_vjp` (B5f/B5q/B5kv) or the trainable STA, the
    halo the trainable STA on its slab and `flash_attention_state` for the
    text states; "flash_int8" raises."""
    b, _, h, d = img_q.shape
    lt = txt_q.shape[1]
    scale = scale if scale is not None else d ** -0.5
    u, r = groups.u, groups.r
    if u > 1:
        img_q, img_k, img_v = (ulysses_scatter(x, groups)
                               for x in (img_q, img_k, img_v))
        hl = h // u
        heads = slice(groups.ulysses_index * hl, (groups.ulysses_index + 1)
                      * hl)
        txt_q, txt_k, txt_v = (x[:, :, heads] for x in (txt_q, txt_k, txt_v))
        if torch.is_tensor(score_bound) and score_bound.ndim \
                and score_bound.shape[-1] == h:   # a bound per head
            score_bound = score_bound[..., heads]
    else:
        hl = h
    s_r = img_q.shape[1]

    if r == 1:
        img_out, txt_out = ulysses_local_attention(
            img_q, img_k, img_v, txt_q, txt_k, txt_v, txt_bias,
            mode=attn_mode, scale=scale, bound_mode=bound_mode,
            score_bound=score_bound, token_grid=token_grid,
            sta_tile=sta_tile, sta_window=sta_window, plain=plain)
    elif attn_mode.startswith("sta"):
        img_out, txt_out = ring_sta_halo(
            img_q, img_k, img_v, txt_q, txt_k, txt_v, txt_bias, groups,
            scale=scale, attn_mode=attn_mode, token_grid=token_grid,
            sta_tile=sta_tile, sta_window=sta_window, bound_mode=bound_mode,
            score_bound=score_bound, plain=plain)
    else:
        mode = (resolve_auto_mode(img_q.device.type, img_q.dtype, d,
                                  s_r + lt)
                if attn_mode == "auto" else attn_mode)
        if (mode == "flash" and bound_mode != "static" and _wants_grad(
                img_q, img_k, img_v, txt_q, txt_k, txt_v)):
            # K2 has no backward: a running-bound ring differentiates
            # through the plain recurrence (JAX flash_ring_kernel=False)
            mode = "sdpa"
        q = torch.cat([img_q, txt_q], dim=1)
        kw = dict(scale=scale, bound_mode=bound_mode,
                  score_bound=score_bound)
        if mode in ("flash", "flash_int8"):
            kw.update(mode=mode, plain=plain, key_mean=(
                ring_key_mean(img_k, txt_k, groups)
                if mode == "flash_int8" else None))
            state = ring_first_hop(q, img_k, img_v, txt_k, txt_v, txt_bias,
                                   **kw)
            k_blk, v_blk = img_k, img_v
            for _ in range(r - 1):
                k_blk, v_blk = ring_send_recv([(k_blk, 1), (v_blk, 1)],
                                              groups)
                state = ring_hop(state, q, k_blk, v_blk, **kw)
            out = state[0]
        elif mode in ("sdpa", "chunked"):
            # the streaming recurrence of the plain modes; the text keys
            # fold once
            state = _init_state(b, hl, s_r + lt, d, q.device)
            state = _partial_attn(q, txt_k, txt_v, txt_bias, state, scale)
            k_blk, v_blk = img_k, img_v
            for hop in range(r):
                if hop:
                    k_blk, v_blk = ring_send_recv([(k_blk, 1), (v_blk, 1)],
                                                  groups)
                state = _partial_attn(q, k_blk, v_blk, None, state, scale)
            out = _finish(state, img_v.dtype)
        else:
            raise NotImplementedError(
                f"attention mode {attn_mode!r} has no ring path")
        img_out, txt_out = out[:, :s_r], out[:, s_r:]

    if u > 1:
        img_out = ulysses_unscatter(img_out.reshape(b, s_r, hl * d), groups)
        txt_out = ulysses_gather_heads(txt_out.reshape(b, lt, hl * d), groups)
    return (img_out.reshape(b, img_out.shape[1], h * d),
            txt_out.reshape(b, lt, h * d))
