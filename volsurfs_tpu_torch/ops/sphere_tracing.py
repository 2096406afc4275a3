"""Sphere tracing of an SDF at test time (counterpart of
volsurfs_tpu/ops/sphere_tracing.py).

JAX marches every ray in lockstep under ``lax.while_loop``, which needs
static shapes. The port marches only the rays still going: the trace keeps
an int32 list of their indices, and each step evaluates the SDF at their
probe points alone (the caller's field, the permutohedral lookup K6 and the
MLP) and advances each listed ray by one march step, kernel K9
(``csrc/sphere_trace.cu``, a thread a listed ray, the state in place) on a
CUDA tensor and its plain version ``compact_step_reference`` (gather the
listed rays, ``sphere_trace_step_reference``'s torch ops in JAX's order,
scatter back) on a CPU tensor. A step writes the next list, the rays still
marching, with their next probe points; the two agree bit for bit but for
the list's order, which on the card comes from atomics. A marching ray
steps by its SDF (at least ``min_step``), and with an occupancy grid at
least to the exit of its empty voxel, or of its empty 4^3 block; a sign
change between two probes brackets the surface, which false position then
refines. The loop ends when no ray is left or after ``nr_sphere_traces``
steps: the host reads the list's length after each step (one sync a step),
so ``steps`` is JAX's count. A converged ray is never stepped again: its t
and flags are the lockstep march's (``march_lockstep_reference``, JAX's
loop with the plain step, is the plain version of the whole march).

The occupied box a grid gives the rays' start, and the coarse 4^3 pooling
of the grid, are computed once a trace with torch ops.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from volsurfs_tpu_torch import _build
from volsurfs_tpu_torch.ops.raycast import BoundingBox, BoundingSphere, intersect_bounding_primitive

# launch counts: the CUDA kernel's and the plain version's
launches = {"sphere_trace_step": 0, "sphere_trace_step_reference": 0}


@dataclasses.dataclass
class TraceSpace:
    """What a march step reads besides the rays and the SDF: the bounding
    primitive (a sphere or a box) and, optionally, the occupancy grid's
    occupied voxels (``occupancy & roi``, uint8 [res^3]) with their 4^3
    pooling (uint8 [(res / C)^3], C = 4 where res % 4 == 0, else 1)."""

    bounding_primitive: object
    thresh: float
    min_step: float
    grid: object = None  # an OccupancyGrid, or None
    coarse: torch.Tensor | None = None
    coarse_factor: int = 1
    eps_skip: float = 0.0

    @property
    def res(self) -> int:
        return self.grid.res

    def divisor(self, n, like):
        """n as a float32 tensor divisor: a CUDA division by a Python number
        multiplies by its reciprocal instead, which rounds otherwise than
        the kernel's division."""
        return torch.tensor(float(n), dtype=torch.float32, device=like.device)


def _exit_dist(space: TraceSpace, pos, rays_d, grid_res: int):
    """[N, 1]: each ray's distance to the exit of its cell of a grid of
    grid_res^3 cells over the occupancy grid's extent."""
    extent = space.grid.extent_tensor()
    n = space.divisor(grid_res, pos)
    cell = extent / n
    coords = torch.floor((pos / extent + 0.5) * grid_res)
    lower = (coords / n - 0.5) * extent
    pos_d = torch.where(rays_d > 0.0, rays_d, 1.0)
    neg_d = torch.where(rays_d < 0.0, rays_d, 1.0)
    t_exit = torch.where(rays_d > 0.0, (lower + cell - pos) / pos_d,
                         torch.where(rays_d < 0.0, (lower - pos) / neg_d, torch.inf))
    return torch.amin(t_exit, dim=-1, keepdim=True)


def _empty_space_skip(space: TraceSpace, pos, rays_d):
    """[N, 1]: the exit of the current voxel, or of the whole 4^3 block
    where the coarse grid marks it empty too, plus eps_skip."""
    fine = _exit_dist(space, pos, rays_d, space.res)
    C = space.coarse_factor
    if C == 1:
        return fine + space.eps_skip
    res_c = space.res // C
    extent = space.grid.extent_tensor()
    cc = torch.clamp(torch.floor((pos / extent + 0.5) * res_c).to(torch.int32), 0, res_c - 1)
    cc = cc.long()
    block_occ = space.coarse.view(res_c, res_c, res_c)[cc[:, 0], cc[:, 1], cc[:, 2]].bool()
    skip = torch.where(block_occ[:, None], fine, _exit_dist(space, pos, rays_d, res_c))
    return skip + space.eps_skip


def sphere_trace_step_reference(state, sdf1, rays_o, rays_d, space: TraceSpace):
    """Plain version of ``sphere_trace_step`` (same arguments; returns the
    new state as new tensors)."""
    launches["sphere_trace_step_reference"] += 1
    t, t_lo, s_lo, t_hi, s_hi, refining, hit, converged = state
    pos = rays_o + t[:, None] * rays_d

    crossed = (sdf1 < 0.0) & (s_lo > 0.0) & (s_lo < 1e9) & ~refining & ~converged
    start_inside = (sdf1 < 0.0) & (s_lo > 1e9) & ~refining & ~converged
    thresh_hit = ((torch.abs(sdf1) < space.thresh) | start_inside) & ~converged
    in_occ = None
    if space.grid is not None:
        in_occ = space.grid.check_occupancy(pos)
        thresh_hit = thresh_hit & (in_occ | refining)

    neg = sdf1 < 0.0
    b_t_lo = torch.where(refining & ~neg, t, t_lo)
    b_s_lo = torch.where(refining & ~neg, sdf1, s_lo)
    b_t_hi = torch.where(refining & neg, t, t_hi)
    b_s_hi = torch.where(refining & neg, sdf1, s_hi)
    b_t_hi = torch.where(crossed, t, b_t_hi)
    b_s_hi = torch.where(crossed, sdf1, b_s_hi)
    now_refining = refining | crossed

    # maximum and minimum, not clamp, as jnp.maximum and jnp.clip
    bound = [torch.tensor(v, dtype=torch.float32, device=t.device) for v in (1e-12, 0.05, 0.95)]
    denom = torch.maximum(b_s_lo - b_s_hi, bound[0])
    frac = torch.minimum(torch.maximum(b_s_lo / denom, bound[1]), bound[2])
    t_secant = b_t_lo + frac * (b_t_hi - b_t_lo)
    bracket_done = (b_t_hi - b_t_lo) < 1e-5

    step = sdf1
    if space.min_step > 0.0:
        floor = torch.tensor(space.min_step, dtype=torch.float32, device=t.device)
        step = torch.where(step > 0.0, torch.maximum(step, floor), step)
    if space.grid is not None:
        step = torch.where(in_occ, step,
                           torch.maximum(step, _empty_space_skip(space, pos, rays_d)[:, 0]))
    t_march = t + step

    newly_hit = (thresh_hit | (now_refining & bracket_done)) & ~converged
    next_t_lo = torch.where(now_refining, b_t_lo, t)
    next_s_lo = torch.where(now_refining, b_s_lo, sdf1)
    t_next = torch.where(now_refining, t_secant, t_march)
    inside = space.bounding_primitive.contains(rays_o + t_next[:, None] * rays_d)
    newly_conv = newly_hit | (~inside & ~now_refining)

    hit = hit | newly_hit
    t_new = torch.where(converged | newly_conv, t, t_next)
    converged = converged | newly_conv
    refining = now_refining & ~converged
    return (t_new, next_t_lo, next_s_lo, b_t_hi, b_s_hi, refining, hit, converged)


def _primitive_args(bound):
    """(kind 0 sphere / 1 box, center [3], radius or half sides [3])."""
    center = [float(x) for x in bound.center.tolist()]
    if isinstance(bound, BoundingSphere):
        return 0, center, [float(np.float32(bound.radius))] * 3
    if isinstance(bound, BoundingBox):
        return 1, center, [float(np.float32(0.5) * np.float32(s)) for s in bound.sides.tolist()]
    raise TypeError(f"sphere_trace_step: unknown bounding primitive {type(bound).__name__}")


def active_rays(state, rays_o, rays_d):
    """The rays of state that have not converged, int32 [M], and their
    probe points o + t d [M, 3]."""
    active = torch.nonzero(~state[7])[:, 0].to(torch.int32)
    o, d = rays_o.index_select(0, active), rays_d.index_select(0, active)
    return active, o + state[0].index_select(0, active)[:, None] * d


def compact_step_reference(state, active, sdf1, rays_o, rays_d, space, count=None):
    """Plain version of ``sphere_trace_step`` (same arguments and results):
    gathers the listed rays, steps them with ``sphere_trace_step_reference``
    and scatters their state back in place. The next list keeps the
    listed order."""
    sub = tuple(x.index_select(0, active) for x in state)
    o, d = rays_o.index_select(0, active), rays_d.index_select(0, active)
    new = sphere_trace_step_reference(sub, sdf1, o, d, space)
    rows = active.long()
    for x, v in zip(state, new):
        x.index_copy_(0, rows, v)
    keep = ~new[7]
    next_active = active[keep]
    next_points = o[keep] + new[0][keep][:, None] * d[keep]
    if count is None:
        count = torch.zeros(1, dtype=torch.int32, device=active.device)
    count.fill_(next_active.shape[0])
    return tuple(state), next_active, next_points, count


def sphere_trace_step(state, active, sdf1, rays_o, rays_d, space, count=None):
    """One march step of the listed rays: state (t, t_lo, s_lo, t_hi, s_hi
    [N] float32, refining, hit, converged [N] bool), active [M] int32 the
    indices of the rays still marching, sdf1 [M] the SDF at their probe
    points o + t d in the list's order, count a zeroed int32 [1] tensor for
    the next list's length (None: a new one). The state's tensors are
    updated in place. Returns (state, next_active [M] int32, next_points
    [M, 3], count): the first ``count`` entries are the rays still marching
    and their next probe points, in an order that varies from run to
    run."""
    if not rays_o.is_cuda:
        return compact_step_reference(state, active, sdf1, rays_o, rays_d, space, count)
    dev = rays_o.device
    N, M = rays_o.shape[0], active.shape[0]
    sdf1 = sdf1.detach().contiguous()
    for name, x, dtype, shape in (("rays_o", rays_o, torch.float32, (N, 3)),
                                  ("rays_d", rays_d, torch.float32, (N, 3)),
                                  ("active", active, torch.int32, (M,)),
                                  ("sdf1", sdf1, torch.float32, (M,))):
        _build.check_tensor(name, x, dtype, shape, dev)
    for name, x in zip(("t", "t_lo", "s_lo", "t_hi", "s_hi"), state[:5]):
        _build.check_tensor(name, x, torch.float32, (N,), dev)
    for name, x in zip(("refining", "hit", "converged"), state[5:]):
        _build.check_tensor(name, x, torch.bool, (N,), dev)
    if count is None:
        count = torch.zeros(1, dtype=torch.int32, device=dev)
    _build.check_tensor("count", count, torch.int32, (1,), dev)
    kind, center, half = _primitive_args(space.bounding_primitive)
    grid = space.grid
    if grid is not None:
        _build.check_tensor("grid.occupied", grid.occupied, torch.uint8, (grid.res,) * 3, dev)
        res_c = grid.res // space.coarse_factor
        _build.check_tensor("coarse", space.coarse, torch.uint8, (res_c,) * 3, dev)
        ex, ey, ez = grid.extent
    else:
        ex = ey = ez = 0.0
    next_active = torch.empty(M, dtype=torch.int32, device=dev)
    next_points = torch.empty(M, 3, dtype=torch.float32, device=dev)
    status = _build.kernels().vs_sphere_trace_step(
        rays_o.data_ptr(), rays_d.data_ptr(), active.data_ptr(), sdf1.data_ptr(),
        *(x.data_ptr() for x in state), next_active.data_ptr(), next_points.data_ptr(),
        count.data_ptr(),
        None if grid is None else grid.occupied.data_ptr(),
        None if grid is None else space.coarse.data_ptr(),
        ex, ey, ez, 0 if grid is None else grid.res, space.coarse_factor, space.eps_skip,
        kind, *center, *half, space.thresh, space.min_step,
        M, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "sphere_trace_step")
    launches["sphere_trace_step"] += 1
    return tuple(state), next_active, next_points, count


def trace_space(bounding_primitive, sdf_converged_tresh, min_step,
                occupancy_grid=None) -> TraceSpace:
    space = TraceSpace(bounding_primitive, float(np.float32(sdf_converged_tresh)),
                       float(np.float32(min_step)))
    if occupancy_grid is not None:
        g = occupancy_grid
        vox = np.float32(g.extent) / np.float32(g.res)
        C = 4 if g.res % 4 == 0 else 1
        res_c = g.res // C
        coarse = g.occupied.view(res_c, C, res_c, C, res_c, C).amax(dim=(1, 3, 5))
        space = dataclasses.replace(space, grid=g, coarse=coarse.contiguous(), coarse_factor=C,
                                    eps_skip=float(np.float32(1e-3) * np.min(vox)))
    return space


def trace_start(rays_o, rays_d, space: TraceSpace):
    """The state of a march before its first step: each ray at its entry
    into the bounding primitive, or with a grid into the box of its occupied
    voxels (plus eps_skip); rays that miss either start converged.
    Returns (t, t_lo, s_lo, t_hi, s_hi, refining, hit, converged)."""
    raycast = intersect_bounding_primitive(space.bounding_primitive, rays_o, rays_d)
    pos0 = raycast["points_near"]
    never_trace = ~raycast["is_hit"]
    if space.grid is not None:
        g = space.grid
        res, extent = g.res, g.extent_tensor()
        occ3 = g.occupied.bool()
        lo_i, hi_i = [], []
        for ax in ((1, 2), (0, 2), (0, 1)):
            m = torch.any(torch.any(occ3, dim=ax[1]), dim=ax[0]).to(torch.uint8)
            lo_i.append(torch.argmax(m))
            hi_i.append(res - 1 - torch.argmax(torch.flip(m, dims=(0,))))
        lo_i, hi_i = torch.stack(lo_i), torch.stack(hi_i)
        nonempty = torch.any(occ3)
        n = space.divisor(res, rays_o)
        box_lo = (lo_i.float() / n - 0.5) * extent
        box_hi = ((hi_i.float() + 1.0) / n - 0.5) * extent
        d_safe = torch.where(torch.abs(rays_d) > 1e-9, rays_d, 1e-9)
        ta = (box_lo[None, :] - rays_o) / d_safe
        tb = (box_hi[None, :] - rays_o) / d_safe
        t_box_lo = torch.amax(torch.minimum(ta, tb), dim=-1, keepdim=True)
        t_box_hi = torch.amin(torch.maximum(ta, tb), dim=-1, keepdim=True)
        t_enter = torch.maximum(raycast["t_near"], t_box_lo)
        t_exit_b = torch.minimum(raycast["t_far"], t_box_hi)
        box_hit = (t_exit_b > t_enter)[:, 0] & nonempty
        pos0 = torch.where(box_hit[:, None], rays_o + (t_enter + space.eps_skip) * rays_d, pos0)
        never_trace = never_trace | ~box_hit
    t0 = torch.sum((pos0 - rays_o) * rays_d, dim=-1)
    n_rays = rays_o.shape[0]
    full = lambda v: torch.full((n_rays,), v, dtype=torch.float32, device=rays_o.device)  # noqa: E731
    false = torch.zeros(n_rays, dtype=torch.bool, device=rays_o.device)
    # distinct tensors: the kernel updates each in place
    return (t0, t0.clone(), full(1e10), full(1e10), full(-1e10), false, false.clone(),
            never_trace)


def march(eval_sdf, rays_o, rays_d, space: TraceSpace, nr_steps: int):
    """The compacted march from ``trace_start``: each step evaluates
    eval_sdf ([M, 3] -> [M]) at the active rays' probe points and steps
    them (``sphere_trace_step``), until no ray is left or after nr_steps
    steps. Returns (the state, the steps taken)."""
    state = trace_start(rays_o, rays_d, space)
    active, points = active_rays(state, rays_o, rays_d)
    # a zeroed count a step, zeroed at once
    counts = torch.zeros(max(nr_steps, 1), dtype=torch.int32, device=rays_o.device)
    steps = 0
    while steps < nr_steps and active.shape[0] > 0:
        state, active, points, count = sphere_trace_step(
            state, active, eval_sdf(points), rays_o, rays_d, space, counts[steps:steps + 1])
        m = int(count.item())  # one host read a step: JAX's loop condition
        active, points = active[:m], points[:m]
        steps += 1
    return state, steps


def march_lockstep_reference(eval_sdf, rays_o, rays_d, space: TraceSpace, nr_steps: int):
    """Plain version of ``march``: JAX's loop, every ray every step (the SDF
    at all N points, ``sphere_trace_step_reference``) while any ray has not
    converged. Returns (the state, the steps taken)."""
    state = trace_start(rays_o, rays_d, space)
    steps = 0
    while steps < nr_steps and bool(torch.any(~state[7])):
        state = sphere_trace_step_reference(state, eval_sdf(rays_o + state[0][:, None] * rays_d),
                                            rays_o, rays_d, space)
        steps += 1
    return state, steps


def sphere_trace(sdf_fn, rays_o, rays_d, bounding_primitive, nr_sphere_traces: int = 30,
                 sdf_converged_tresh: float = 1e-4, occupancy_grid=None,
                 min_step: float = 0.0) -> dict:
    """March rays [N, 3] along the SDF (sdf_fn: [N, 3] -> [N, 1], or a tuple
    with that first) until |sdf| < sdf_converged_tresh or they leave the
    bounding primitive. With occupancy_grid the rays start at their entry
    into the box of its occupied voxels (rays that miss it never march),
    skip empty voxels and blocks, and take threshold hits only in occupied
    voxels (bracketed crossings count anywhere). Returns positions [N, 3],
    z [N, 1], is_hit [N] and steps (the steps taken, an int)."""
    space = trace_space(bounding_primitive, sdf_converged_tresh, min_step, occupancy_grid)
    rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()

    def eval_sdf(p):
        out = sdf_fn(p)
        sdf = out[0] if isinstance(out, tuple) else out
        return sdf[..., 0] if sdf.ndim > 1 else sdf

    state, steps = march(eval_sdf, rays_o, rays_d, space, nr_sphere_traces)
    t, _, _, _, _, refining, hit, converged = state
    # rays still refining at the cap have a proven bracket: hits
    hit = hit | refining
    return {"positions": rays_o + t[:, None] * rays_d, "z": t[:, None], "is_hit": hit,
            "steps": steps}
