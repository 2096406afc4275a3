"""Permutohedral-lattice hash lookup, with its spatial Jacobian and its table
gradient (kernel K6).

Counterpart of volsurfs_tpu/models/encodings.py's ``PermutoEncoder.__call__``
(:1039-1232) with ``_hash_lookup_cm`` / ``_hash_lookup_grad_cm`` and their
backward passes (:878-986). For every (point, level) the point is elevated
onto the hyperplane x.1 = 0 of R^4 through a [3, 4L] projection (the level's
1/scale folded in), the enclosing simplex is found by ranking the residuals,
and its 4 corners are hashed into the level's rows (primes 1, 2654435761,
805459861, uint32 wrap-around, ``% size``); each row holds F = 2 features.

``permuto_forward`` returns the features [N, 2L] (column 2l + f) and, with
grads, their Jacobian dfeats [3, N, 2L] (K leading). Its plain version, with
``save``, also gives the absolute rows ``idx`` [N, 4L] int32 (column c*L +
l), the barycentric weights ``bary`` [N, 4L] and each (point, level)'s
simplex as a rank code [N, L] uint8 (2 bits a residual), from which the
constant weight Jacobian dbary follows. ``permuto_backward`` gives the
table's gradient, the update ``bary * dout + sum_k dbary_k * gd_k`` of every
(point, level, corner) summed into the corner's row, and, where the points
need one, their gradient: the features' cotangent through the weights,
``sum (g . dout) * d bary / d unit`` over levels and corners, as JAX's custom
VJPs return ``d_bary``. Its kernel recomputes the rows and weights from the
points and accumulates the gradient itself, so no update tensor is stored
and no scatter kernel follows. ``permuto_lookup`` is the differentiable
entry point; its forward saves nothing but the points.

On a CUDA tensor each wrapper launches its kernel (``csrc/permuto.cu``); on
a CPU tensor it runs the plain version, torch ops in the JAX op order (the
backward's: ``permuto_backward_reference``, then
``scatter_add_rows_reference``). The elevation is XLA:CPU's: fma(p2, W2,
fma(p1, W1, p0 * W0)); the kernels make the same fmas and no others
(``-fmad=false``), so the simplices, rows and weights the kernels compute
(the backward's recomputed ones too) equal the plain version's bit for bit
on the card, and so do feats and dfeats (the corner sums in the same order)
and the points' gradient (the plain version sums it as the kernel does);
the table's gradient sums each row's updates in another order (atomics),
so it agrees to float32 summation error.
"""

from __future__ import annotations

import torch

from volsurfs_tpu_torch import _build
from volsurfs_tpu_torch.ops.scatter_add import scatter_add_rows_reference
from volsurfs_tpu_torch.utils.math import MASK32, fma32, mul_u32

PRIMES = (1, 2654435761, 805459861)
D = 3  # the lattice's dimension; each simplex has D + 1 = 4 corners

# launch counts: the CUDA kernels' and their plain versions'
launches = {
    "permuto_fwd": 0, "permuto_fwd_reference": 0,
    "permuto_bwd": 0, "permuto_bwd_reference": 0,
}


def _elevate(unit, W):
    """[N, 3] @ [3, 4L] as fma(p2, W2, fma(p1, W1, p0 * W0)), XLA:CPU's
    rounding of the float32 dot."""
    p = [unit[:, k:k + 1] for k in range(3)]
    return fma32(p[2], W[2], fma32(p[1], W[1], p[0] * W[0]))


def _to_int32(x):
    """float32 -> int32 toward zero, saturating out of range as XLA's and
    CUDA's conversions do (the CPU's own gives INT_MIN there: the invalid
    samples' depth, 1e10, elevates far past 2^31)."""
    return x.double().clamp(-2.0 ** 31, 2.0 ** 31 - 1).to(torch.int32)


def _by_rank(rank):
    """[N, L, 4] int64: at [..., r] the residual j whose rank is r (the
    last such j, 0 if none: the ranks are a permutation but where the
    float32 residuals lose all precision, at the invalid samples' depth).
    rank: 4 x [N, L] int."""
    inv = []
    for r in range(D + 1):
        acc = torch.zeros_like(rank[0])
        for j in range(D + 1):
            acc = torch.where(rank[j] == r, j, acc)
        inv.append(acc)
    return torch.stack(inv, dim=-1).long()


def _pos_neg(sel, c):
    """The two rank-picked entries of corner c: sel[..., D - c],
    sel[..., (D + 1 - c) mod (D + 1)]."""
    return sel[..., D - c], sel[..., (D + 1 - c) % (D + 1)]


def _dbary(inv, ddiff):
    """The corner weights' spatial Jacobian [3, N, 4L] (corner-major): for
    corner c, d residual / d p_k of the rank-(D - c) residual less that of
    the rank-((D + 1 - c) mod 4) one (JAX's masked slot sums, which add
    exactly these two terms and zeros). inv [N, L, 4] from ``_by_rank``,
    ddiff [4, 3, L]."""
    N, L = inv.shape[:2]
    dd = ddiff.permute(1, 2, 0)[:, None].expand(3, N, L, D + 1)  # [3, N, L, j]
    sel = torch.gather(dd, -1, inv[None].expand(3, N, L, D + 1))  # [3, N, L, r]
    db = [a - b for a, b in (_pos_neg(sel, c) for c in range(D + 1))]
    return torch.stack(db, dim=2).reshape(3, N, (D + 1) * L)


def _unpack_ranks(code):
    code = code.long()
    return [(code >> (2 * j)) & 3 for j in range(D + 1)]


def _corner_sums(gathered, weights, L):
    """[N, 2L] with column 2l + f = sum_c weights[:, cL + l] * g_f, the sum
    taken corner by corner from corner 0."""
    parts = []
    for f in range(gathered.shape[-1]):
        wg = weights * gathered[..., f]
        acc = wg[:, :L]
        for c in range(1, D + 1):
            acc = acc + wg[:, c * L:(c + 1) * L]
        parts.append(acc)
    return torch.stack(parts, dim=-1).reshape(weights.shape[0], -1)


def permuto_forward_reference(unit, table, W, sizes, offsets, ddiff=None, save=True):
    """Plain version of ``permuto_forward`` (same arguments). Returns
    (feats, dfeats or None, idx, bary, rank code), the last three None
    without ``save``."""
    launches["permuto_fwd_reference"] += 1
    return _forward_plain(unit, table, W, sizes, offsets, ddiff, save)


def _forward_plain(unit, table, W, sizes, offsets, ddiff, save):
    L = sizes.shape[0]
    elev = _elevate(unit, W)
    ej = [elev[:, j * L:(j + 1) * L] for j in range(D + 1)]
    mean = (ej[0] + ej[1] + ej[2] + ej[3]) * (1.0 / (D + 1))
    ej = [e - mean for e in ej]

    # closest remainder-0 lattice point, per residual
    rem0 = []
    for e in ej:
        down = torch.floor(e / (D + 1)) * (D + 1)
        up = down + (D + 1)
        rem0.append(torch.where(e - down < up - e, down, up))
    sum_rem = (rem0[0] + rem0[1] + rem0[2] + rem0[3]) * (1.0 / (D + 1))

    # rank the residuals (largest -> 0, ties by index), then wrap
    diff = [ej[j] - rem0[j] for j in range(D + 1)]
    rank = [torch.zeros_like(diff[0], dtype=torch.int32) for _ in range(D + 1)]
    for i in range(D + 1):
        for j in range(i + 1, D + 1):
            lt = (diff[i] < diff[j]).to(torch.int32)
            rank[i] = rank[i] + lt
            rank[j] = rank[j] + (1 - lt)
    sr = _to_int32(sum_rem)
    for j in range(D + 1):
        r = rank[j] + sr
        rem0[j] = torch.where(r < 0, rem0[j] + (D + 1), rem0[j])
        r = torch.where(r < 0, r + (D + 1), r)
        rem0[j] = torch.where(r > D, rem0[j] - (D + 1), rem0[j])
        rank[j] = torch.where(r > D, r - (D + 1), r)

    # barycentric weights: JAX's slots b[d - rank_j] += diff_j, b[d + 1 -
    # rank_j] -= diff_j, b[0] += 1 + b[d + 1], each the difference of two
    # residuals picked by rank
    diff = torch.stack([(ej[j] - rem0[j]) * (1.0 / (D + 1)) for j in range(D + 1)], dim=-1)
    inv = _by_rank(rank)
    sel = torch.gather(diff, -1, inv)  # [N, L, r]
    pos, neg = _pos_neg(sel, 0)
    bary = [pos + (1.0 + (0.0 - neg))]
    bary += [a - b for a, b in (_pos_neg(sel, c) for c in range(1, D + 1))]
    bary = torch.cat(bary, dim=1)

    # corner keys -> hashed absolute rows (uint32 arithmetic in int64): a
    # corner's key k is rem0_k, or rem0_k + (D + 1) where rank_k >= D + 1 -
    # corner, so each coordinate's two hashed terms are made once
    sizes_l = sizes.long()[None, :]
    offsets_l = offsets.long()[None, :]
    terms = []
    for k in range(D):
        keys = [_to_int32(rem0[k] + add).long() & MASK32 for add in (0.0, float(D + 1))]
        terms.append([mul_u32(key, PRIMES[k]) for key in keys])
    corners = []
    for corner in range(D + 1):
        h = None
        for k in range(D):
            term = torch.where(rank[k] >= D + 1 - corner, terms[k][1], terms[k][0])
            h = term if h is None else h ^ term
        corners.append(h % sizes_l + offsets_l)
    idx = torch.cat(corners, dim=1).to(torch.int32)

    gathered = table.index_select(0, idx.reshape(-1)).reshape(*idx.shape, -1)  # [N, 4L, F]
    feats = _corner_sums(gathered, bary, L)
    dfeats = None
    if ddiff is not None:
        dbary = _dbary(inv, ddiff)
        dfeats = torch.stack([_corner_sums(gathered, dbary[k], L) for k in range(3)], dim=0)
    if not save:
        return feats, dfeats, None, None, None
    code = rank[0] | (rank[1] << 2) | (rank[2] << 4) | (rank[3] << 6)
    return feats, dfeats, idx, bary, code.to(torch.uint8)


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def permuto_forward(unit, table, W, sizes, offsets, ddiff=None):
    """Features of points in the unit cube, and with ``ddiff`` their
    Jacobian.

    unit [N, 3] float32; table [R, 2] float32 (every level's rows, coarse to
    fine); W [3, 4L] the elevation (column j*L + l = E[j] / scale_l);
    sizes, offsets [L] int32 (each level's rows and its first row); ddiff
    [4, 3, L] float32 (d residual_j / d p_k, the unit rescale included) or
    None. Returns (feats [N, 2L], dfeats [3, N, 2L] or None)."""
    if not unit.is_cuda:
        return permuto_forward_reference(unit, table, W, sizes, offsets, ddiff, save=False)[:2]
    dev = unit.device
    N, L = unit.shape[0], sizes.shape[0]
    _build.check_tensor("unit", unit, torch.float32, (N, 3), dev)
    _build.check_tensor("table", table, torch.float32, (table.shape[0], 2), dev)
    _build.check_tensor("W", W, torch.float32, (3, 4 * L), dev)
    _build.check_tensor("sizes", sizes, torch.int32, (L,), dev)
    _build.check_tensor("offsets", offsets, torch.int32, (L,), dev)
    with_grad = ddiff is not None
    if with_grad:
        _build.check_tensor("ddiff", ddiff, torch.float32, (D + 1, 3, L), dev)
    feats = torch.empty(N, 2 * L, dtype=torch.float32, device=dev)
    dfeats = torch.empty(3, N, 2 * L, dtype=torch.float32, device=dev) if with_grad else None
    status = _build.kernels().vs_permuto_forward(
        unit.data_ptr(), W.data_ptr(), sizes.data_ptr(), offsets.data_ptr(), table.data_ptr(),
        _ptr(ddiff), feats.data_ptr(), _ptr(dfeats), N, L,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "permuto_forward")
    launches["permuto_fwd"] += 1
    return feats, dfeats


def permuto_backward_reference(idx, bary, code, dout, ddiff=None, gd=None, table=None, W=None,
                               updates=True):
    """Plain version of ``permuto_backward``."""
    launches["permuto_bwd_reference"] += 1
    N, CL = bary.shape
    L = CL // (D + 1)
    d = dout.reshape(N, L, 2)
    dt = [d[..., f].repeat(1, D + 1) for f in range(2)]  # the level's cotangent for each corner
    inv = _by_rank(_unpack_ranks(code)) if gd is not None or table is not None else None
    upd = d_unit = None
    if updates:
        dbary = _dbary(inv, ddiff) if gd is not None else None
        parts = []
        for f in range(2):
            u = bary * dt[f]
            if gd is not None:
                for k in range(3):
                    u = u + dbary[k] * gd[k].reshape(N, L, 2)[..., f].repeat(1, D + 1)
            parts.append(u)
        upd = torch.stack(parts, dim=-1).reshape(N * CL, 2)
    if table is not None:
        g = table.index_select(0, idx.reshape(-1)).reshape(N, CL, 2)
        dg = g[..., 0] * dt[0] + g[..., 1] * dt[1]  # [N, 4L]
        # d residual_j / d unit_k = W[k, jL + l] / 4, as [4, 3, L]
        dunit = W.reshape(3, D + 1, L).permute(1, 0, 2)
        terms = dg * (_dbary(inv, dunit) * 0.25)  # [3, N, 4L]
        # the kernel's order: each lane l sums its levels l, l + 32, ... and
        # their corners in turn, then the warp adds lanes by xor shuffles
        lanes = -(-L // 32) * 32
        terms = torch.nn.functional.pad(terms.reshape(3, N, D + 1, L), (0, lanes - L))
        acc = torch.zeros(3, N, 32, dtype=terms.dtype, device=terms.device)
        for base in range(0, lanes, 32):
            for c in range(D + 1):
                acc = acc + terms[:, :, c, base:base + 32]
        for off in (16, 8, 4, 2, 1):
            acc = acc + acc[..., torch.arange(32, device=acc.device) ^ off]
        d_unit = acc[..., 0].T.contiguous()
    return upd, d_unit


def permuto_backward_fused_reference(unit, table, W, sizes, offsets, dout, ddiff=None, gd=None,
                                     want_table=True, want_unit=False):
    """Plain version of ``permuto_backward`` (same arguments and results):
    the rows, weights and rank codes as ``permuto_forward_reference`` makes
    them, then ``permuto_backward_reference`` and
    ``scatter_add_rows_reference``."""
    idx, bary, code = _forward_plain(unit, table, W, sizes, offsets, None, True)[2:]
    upd, d_unit = permuto_backward_reference(idx, bary, code, dout, ddiff, gd,
                                             table if want_unit else None, W, want_table)
    if not want_table:
        return None, d_unit
    return scatter_add_rows_reference(idx.reshape(-1), upd, table.shape[0]), d_unit


def permuto_backward(unit, table, W, sizes, offsets, dout, ddiff=None, gd=None, want_table=True,
                     want_unit=False):
    """The backward of a lookup of ``unit`` [N, 3] in ``table`` [R, 2], with
    the lookup's W, sizes and offsets (and ``ddiff`` with grads). dout
    [N, 2L] is the cotangent of the features, gd [3, N, 2L] (or None) that
    of dfeats. Returns (d_table [R, 2], the sum over (point, level, corner)
    of ``bary * dout + sum_k dbary_k * gd_k`` into the corner's row, or None
    without ``want_table``; d_unit [N, 3], the points' gradient, or None
    without ``want_unit``). The kernel recomputes the rows and weights from
    the points."""
    if not unit.is_cuda:
        return permuto_backward_fused_reference(unit, table, W, sizes, offsets, dout, ddiff, gd,
                                                want_table, want_unit)
    dev = unit.device
    N, L, R = unit.shape[0], sizes.shape[0], table.shape[0]
    _build.check_tensor("unit", unit, torch.float32, (N, 3), dev)
    _build.check_tensor("table", table, torch.float32, (R, 2), dev)
    _build.check_tensor("W", W, torch.float32, (3, 4 * L), dev)
    _build.check_tensor("sizes", sizes, torch.int32, (L,), dev)
    _build.check_tensor("offsets", offsets, torch.int32, (L,), dev)
    _build.check_tensor("dout", dout, torch.float32, (N, 2 * L), dev)
    if gd is not None:
        _build.check_tensor("gd", gd, torch.float32, (3, N, 2 * L), dev)
        _build.check_tensor("ddiff", ddiff, torch.float32, (D + 1, 3, L), dev)
    d_table = torch.empty(R, 2, dtype=torch.float32, device=dev) if want_table else None
    d_unit = torch.empty(N, 3, dtype=torch.float32, device=dev) if want_unit else None
    status = _build.kernels().vs_permuto_backward(
        unit.data_ptr(), W.data_ptr(), sizes.data_ptr(), offsets.data_ptr(),
        _ptr(ddiff if gd is not None else None), table.data_ptr(), dout.data_ptr(), _ptr(gd),
        _ptr(d_table), _ptr(d_unit), N, L, R, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "permuto_backward")
    launches["permuto_bwd"] += 1
    return d_table, d_unit


def _lookup_backward(ctx, dout, gd=None):
    """The table's gradient and the points', as asked, in one kernel that
    recomputes the rows and weights from the points."""
    table, unit, W, sizes, offsets, ddiff = ctx.saved_tensors
    want_table, want_unit = ctx.needs_input_grad[:2]
    return permuto_backward(unit, table, W, sizes, offsets, dout.contiguous(), ddiff,
                            None if gd is None else gd.contiguous(), want_table, want_unit)


class PermutoLookup(torch.autograd.Function):
    """feats [N, 2L] of points; gradients to the table and the points."""

    @staticmethod
    def forward(ctx, table, unit, W, sizes, offsets):
        feats = permuto_forward(unit, table.detach(), W, sizes, offsets)[0]
        ctx.save_for_backward(table.detach(), unit, W, sizes, offsets, None)
        return feats

    @staticmethod
    def backward(ctx, dout):
        return (*_lookup_backward(ctx, dout), None, None, None)


class PermutoLookupWithGrad(torch.autograd.Function):
    """(feats [N, 2L], dfeats [3, N, 2L]) of points; the gradients of both
    go to the table, and the features' to the points too (dfeats is
    constant in the points inside a simplex)."""

    @staticmethod
    def forward(ctx, table, unit, W, sizes, offsets, ddiff):
        feats, dfeats = permuto_forward(unit, table.detach(), W, sizes, offsets, ddiff)
        ctx.save_for_backward(table.detach(), unit, W, sizes, offsets, ddiff)
        return feats, dfeats

    @staticmethod
    def backward(ctx, dout, gd):
        return (*_lookup_backward(ctx, dout, gd), None, None, None, None)


def permuto_lookup(table, unit, W, sizes, offsets, ddiff=None):
    """feats [N, 2L] of points in the unit cube, or with ``ddiff`` (feats,
    dfeats [3, N, 2L]), differentiable in the table and the points. The
    forward saves nothing for the backward, which recomputes the rows and
    weights from the points."""
    if torch.is_grad_enabled() and (table.requires_grad or unit.requires_grad):
        if ddiff is None:
            return PermutoLookup.apply(table, unit, W, sizes, offsets)
        return PermutoLookupWithGrad.apply(table, unit, W, sizes, offsets, ddiff)
    feats, dfeats = permuto_forward(unit, table.detach(), W, sizes, offsets, ddiff)
    return feats if ddiff is None else (feats, dfeats)
