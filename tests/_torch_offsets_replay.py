"""Replays an offsets_surfs occupancy dip on the CPU through the port and
through volsurfs_tpu, from a state that ``chip_stage_runs.py`` saved on the
card (a helper, not a tier-1 test; imports JAX):

    JAX_PLATFORMS=cpu python tests/_torch_offsets_replay.py DIP.npz [--rays N]
        [--port-only | --points] [--scale S --offsets-init-steps N --clip on|off]

DIP.npz holds the parameters from before the refresh whose occupied share
fell (the SDF's in float32, the colour and transparency tables in
float16), the card's grid before and after that refresh, the iteration
and the ray batches of the 5 steps after it. Both sides take the same
parameters: the port's by name, JAX's through the flax trees of
tests/_torch_offsets_pair.py (the inverse of ``convert.py``). JAX runs op
by op. JAX cannot build base_5.cfg (its ``small_cumsum`` raises on the
empty outer-offsets axis); here, and only here,
``volsurfs_tpu.models.fields._small_cumsum`` returns an empty axis as it
is, as the port's does (ROADMAP.md Queue 3, "matched on purpose").

1. The refresh at full width (256^3 voxels, the cut schedule's variance):
   the occupied sets of the port and of JAX must be equal but for voxels
   whose |sdf| - half_diag lies within 1e-6 of the threshold's distance
   (the logistic density's 1e-4); the card's set after the refresh is
   reported beside them.
2. The 5 steps after it, on each recorded batch (all of its rays unless
   --rays N takes the first N), on the refreshed grid: losses and every
   parameter's gradient within tests/test_torch_offsets_surfs_data_steps.py's
   tolerances (``_torch_offsets_steps.TOLERANCES``), both sides with the
   same random draws and JAX with the port's samples (as those tests do)
   and the port's random points (JAX's formula rounds some an ulp apart).
   The optimizer's moments are not saved (chip_stage_runs.py keeps a
   state under 64 MiB): after each step the port takes an Adam step from zero
   moments at the schedule's learning rate of that iteration, and JAX
   takes the port's new parameters, so each step compares both packages
   on one state. Beside each step, the port's gradients with every
   parameter moved by one float32 ulp (the same samples and draws) give
   the float32 noise floor of those gradients at that state, reported as
   a diagnostic (``grads_over_noise``: the gradients outside their
   tolerance and above NOISE_FACTOR times that floor); it does not enter
   the verdict. And beside each step, the
   port's gradients with its MLPs' tangents computed as JAX computes them,
   (W t + b) - b where the port takes W t, against JAX's
   (``jax_tangents_grad_rel_err``): what of the difference that formula
   accounts for.

Prints one JSON line a check and a last line with the verdict; exits 1 if
a check fails: the refresh's sets differ or a loss or gradient lies outside
its tolerance. ``--port-only`` runs the port's refresh and the noise floor
alone (minutes, where JAX's op-by-op steps take tens of minutes each).
"""

import argparse
import json
import os
import sys
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [HERE, REPO]

from volsurfs_tpu.methods.offsets_surfs import OffsetsSurfs as JOffsetsSurfs  # noqa: E402
from volsurfs_tpu.models import fields as JF  # noqa: E402
from volsurfs_tpu.ops import samples as JS  # noqa: E402
from volsurfs_tpu.ops.raycast import make_bounding_sphere as j_sphere  # noqa: E402
from volsurfs_tpu.params.hyper_params import HyperParamsOffsetsSuRFs as JHP  # noqa: E402
from volsurfs_tpu_torch.methods.offsets_surfs import OffsetsSurfs  # noqa: E402
from volsurfs_tpu_torch.models.mlp import MLP, _derivatives  # noqa: E402
from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere  # noqa: E402
from volsurfs_tpu_torch.utils.schedules import get_logistic_beta_from_variance  # noqa: E402

from _torch_offsets_pair import flat_grads, flax_params, port_grads  # noqa: E402
from _torch_offsets_steps import TOLERANCES  # noqa: E402
from _torch_surf_pair import Draws, feed, jax_grid, jax_value_and_grad  # noqa: E402

OCCUPANCY_THRESH = 1e-4
NEAR_THRESH = 1e-6
# a gradient whose port-JAX difference exceeds both its tolerance and this
# many times the port's own change under a one-ulp move of the parameters
# is outside float32 noise
NOISE_FACTOR = 10.0


def emit(check, **fields):
    print(json.dumps({"check": check, **fields}), flush=True)


def _chip_smoke():
    """chip_smoke.py's offsets_surfs configuration, its watchdog off."""
    import faulthandler

    import chip_smoke

    faulthandler.cancel_dump_traceback_later()
    return chip_smoke


def _threshold_distance(beta):
    """The distance d at which the logistic density of beta falls to the
    occupancy threshold (float64 bisection; the density falls with d)."""
    def pdf(x):
        e = np.exp(-beta * x)
        return beta * e / (1.0 + e) ** 2

    lo, hi = 0.0, 10.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if pdf(mid) > OCCUPANCY_THRESH else (lo, mid)
    return 0.5 * (lo + hi)


def _small_cumsum_keeping_empty(real):
    def small_cumsum(x, axis):
        return x if x.shape[axis] == 0 else real(x, axis)
    return small_cumsum


def load(path, schedule):
    """(port method on the CPU with the saved parameters, its hp, meta,
    the batches, the card's grids). schedule: the run's scale,
    offsets-init steps and clip setting, where the file does not hold
    them."""
    z = np.load(path)
    meta = json.loads(z["meta"].tobytes())
    schedule = meta.get("schedule", schedule)
    chip_smoke = _chip_smoke()
    chip_smoke.OFFSETS_SCALE = schedule["scale"]
    chip_smoke.OFFSETS_INIT_STEPS = schedule["offsets_init_steps"]
    chip_smoke.OFFSETS_CLIP_TO_OCCUPANCY = schedule["clip"]
    hp, cuts = chip_smoke.offsets_hyper_params()
    method = OffsetsSurfs(hp, make_bounding_sphere(1.0), bg_color="white", occupancy_res=256,
                          device="cpu", seed=0)
    for name, module in method.models.items():
        module.load_state_dict({k: torch.from_numpy(z[f"param/{name}.{k}"].astype(np.float32))
                                for k in module.state_dict()})
    method.iter_nr = meta["iter_nr"]
    batches = []
    for i in range(5):
        keys = [k for k in z.files if k.startswith(f"batch{i}/")]
        batches.append({k.split("/", 1)[1]: z[k] for k in keys})
    n = 256 ** 3
    grids = {k: np.unpackbits(z[k])[:n].astype(bool) for k in ("grid_before", "grid_after")}
    return method, hp, cuts, meta, batches, grids


def jax_method(hp):
    fields = {f for f in JHP.__dataclass_fields__ if hasattr(hp, f)}
    jhp = JHP(**{f: getattr(hp, f) for f in fields})
    return JOffsetsSurfs(jhp, j_sphere(1.0), bg_color="white", occupancy_res=256,
                         key=jax.random.PRNGKey(0))


def replay_refresh(method, jmethod, jparams, card_after):
    it = method.iter_nr
    t = time.perf_counter()
    method.update_occupancy_grid()
    port_s = time.perf_counter() - t
    state = jmethod.init_state().replace(params=jparams, iter_nr=jnp.asarray(it, jnp.int32))
    t = time.perf_counter()
    with jax.disable_jit():
        jstate = jmethod.update_occupancy_grid(state)
    jax_s = time.perf_counter() - t
    port_occ = method.grid.occupancy.numpy().reshape(-1)
    jax_occ = np.asarray(jstate.grid.occupancy).reshape(-1)
    port_vals = method.grid.values.numpy().reshape(-1)
    jax_vals = np.asarray(jstate.grid.values).reshape(-1)
    variance = min(np.float32(0.8), np.float32(method._variance(it)))
    beta = float(get_logistic_beta_from_variance(variance))
    half_diag = 0.5 * float(np.linalg.norm(method.grid.voxel_size().numpy()))
    d_thresh = _threshold_distance(beta)
    near = np.abs(np.maximum(np.abs(port_vals) - half_diag, 0.0) - d_thresh) < NEAR_THRESH
    differ = port_occ != jax_occ
    roi = method.grid.roi.numpy().reshape(-1)

    def share(occ):  # as OccupancyGrid.occupancy_fraction
        return float((occ & roi).sum() / max(roi.sum(), 1))

    result = dict(iter_nr=it, variance=float(variance), beta=beta, threshold_distance=d_thresh,
                  port_share=share(port_occ), jax_share=share(jax_occ),
                  card_share=share(card_after),
                  voxels_differ=int(differ.sum()), voxels_differ_not_near=int((differ & ~near).sum()),
                  voxels_near_threshold=int(near.sum()),
                  port_card_differ=int((port_occ != card_after).sum()),
                  max_abs_value_diff=float(np.abs(port_vals - jax_vals).max()),
                  port_s=port_s, jax_s=jax_s)
    result["ok"] = result["voxels_differ_not_near"] == 0
    emit("refresh", **result)
    return result


def _draws(rng, R, S, n_imp, sampler=True, points=True):
    """A data step's random draws: the sampler's jitter (to the port alone,
    unless sampler is False: the samples are given), the 1,024 random
    points' (unless points is False: the points are given) and the
    curvature directions."""
    jitter = [rng.uniform(0, 1, (R, 1)).astype(np.float32),
              rng.uniform(-0.5, 0.5, (R, n_imp)).astype(np.float32),
              rng.uniform(-0.5, 0.5, (R, n_imp)).astype(np.float32)]
    requests = [((1024, 3), rng.standard_normal((1024, 3)).astype(np.float32)),
                ((1024, 1), rng.uniform(0, 1, (1024, 1)).astype(np.float32)),
                ((R, S, 3), rng.standard_normal((R, S, 3)).astype(np.float32))]
    return Draws(requests if points else requests[2:],
                 port_only=jitter if sampler else ())


def _random_points(method, rng, R, S, n_imp):
    """The port's 1,024 random points of a step's draws (JAX's own formula
    rounds 1 in ~8 of them an ulp apart, which moves the rough hash-grid
    SDF's gradients there)."""
    requests = _draws(rng, R, S, n_imp).jax_queue
    return method.bounding_primitive.points_from_draws(
        torch.from_numpy(requests[0][1]), torch.from_numpy(requests[1][1])).numpy()


def _port_step(method, batch, it, draws, samples=None):
    """The port's loss and gradients of one data step on the draws; the
    sampler's output is recorded, or replaced by samples if given.
    Returns (losses, grads by name, the samples)."""
    taken = {}
    sample = method._sample_rays

    def sampler(*args, **kwargs):
        taken["samples"] = samples if samples is not None else sample(*args, **kwargs)
        return taken["samples"]

    with pytest.MonkeyPatch.context() as mp:
        feed(mp, method, draws)
        mp.setattr(method, "_sample_rays", sampler)
        method.optimizer.zero_grad(set_to_none=True)
        loss, losses = method._loss({key: torch.from_numpy(v) for key, v in batch.items()}, it)
        loss.backward()
    assert not draws.port_queue
    return losses, port_grads(method), taken["samples"]


def _jax_step(jmethod, method, params, batch, it, draws, samples, points):
    """JAX's losses and gradients of the same step, op by op, on the
    port's samples and random points and the same draws."""
    phase = method.phase(it)
    grid = jax_grid(jmethod, method.grid)
    given = JS.RaySamples(**{f: jnp.asarray(getattr(samples, f).numpy()) for f in (
        "z", "dt", "mask", "rays_o", "rays_d", "t_near", "t_far", "max_dt")})
    with pytest.MonkeyPatch.context() as mp:
        feed(mp, method, draws)
        mp.setattr(jmethod, "_sample_rays", lambda *a, **k: given)
        mp.setattr(type(jmethod.bounding_primitive), "get_random_points_inside",
                   lambda self, key, n: jnp.asarray(points))
        with jax.disable_jit():
            losses, grads = jax_value_and_grad(
                lambda p: jmethod._data_loss(
                    p, grid, {key: jnp.asarray(v) for key, v in batch.items()}, it,
                    jax.random.PRNGKey(0), phase in ("first", "second"), phase != "color_init"),
                params)
    assert not draws.jax_queue
    return losses, flat_grads(grads)


def _jax_tangents(self, x, t):
    """The port's MLP tangents computed as JAX computes them: each layer's
    image of a tangent is (W t + b) - b (the bias row's output subtracted),
    where the port takes W t."""
    for i in range(self.nr_layers):
        layer = getattr(self, f"dense_{i}")
        z = layer(x)
        dz = F.linear(t, layer.weight, layer.bias) - layer.bias
        if i == self.nr_layers - 1 and self.last_layer_linear:
            x, t = z, dz
        else:
            x, t = self.activation(z), dz * _derivatives(self.activation_name, z)
    return x, t


def _rel_err(got, ref):
    return {key: float(np.linalg.norm(got[key] - r) / np.linalg.norm(r)) if np.any(r)
            else float(np.linalg.norm(got[key])) for key, r in ref.items()}


def diagnose_points(method, jmethod, batch, nr_rays, top=8):
    """The first recorded step's points (its samples, on the refreshed grid,
    and the 1,024 random points) through both packages' SDFs with grads:
    every surface's value and gradient, the worst points by the support
    surfaces' gradient difference."""
    hp = method.hp
    S = hp.max_nr_samples_per_ray + hp.max_nr_imp_samples_per_ray
    batch = {key: batch[key][slice(nr_rays)] for key in ("rays_o", "rays_d", "gt_rgb", "gt_mask")}
    R = batch["rays_o"].shape[0]
    draws = _draws(np.random.default_rng(100), R, S, hp.max_nr_imp_samples_per_ray // 2)
    _, _, samples = _port_step(method, batch, method.iter_nr, draws)
    normals, uniforms = draws.jax_queue[0][1], draws.jax_queue[1][1]
    rand = method.bounding_primitive.points_from_draws(torch.from_numpy(normals),
                                                       torch.from_numpy(uniforms))
    mask = samples.mask.reshape(-1)
    pts = torch.cat([samples.positions().reshape(-1, 3)[mask], rand]).detach()
    with torch.no_grad():
        sdfs, _, _, grads = method._sdfs_with_grads(pts, method.iter_nr)
    params = {name: flax_params(module) for name, module in method.models.items()}
    jpts = jnp.asarray(pts.numpy())

    def fields(p):
        out = jmethod._sdfs_with_grads(p, jpts, method.iter_nr)
        return out[0], out[3]

    with jax.disable_jit():
        jsdfs, jgrads = fields(params)
        # the same fields as JAX's train step computes them: under autodiff,
        # where the encoder's custom VJP runs its forward rule
        (vsdfs, vgrads), _ = jax.vjp(fields, params)
    sdfs, grads = sdfs.numpy()[..., 0], grads.numpy()
    jsdfs, jgrads = np.asarray(jsdfs)[..., 0], np.asarray(jgrads)
    vsdfs, vgrads = np.asarray(vsdfs)[..., 0], np.asarray(vgrads)
    vdiff = np.abs(vgrads - jgrads).max(axis=(1, 2))
    emit("jax_under_autodiff", max_abs_sdf_diff=float(np.abs(vsdfs - jsdfs).max()),
         max_abs_grad_diff=float(vdiff.max()),
         points_grad_diff_over_1e_3=int((vdiff > 1e-3).sum()),
         worst=[dict(index=int(i), random_point=bool(i >= int(mask.sum())),
                     grad_diff=float(vdiff[i]),
                     plain_grad_norms=np.linalg.norm(jgrads[i], axis=-1).tolist(),
                     autodiff_grad_norms=np.linalg.norm(vgrads[i], axis=-1).tolist())
                for i in np.argsort(-vdiff)[:top]])
    diff = np.abs(grads - jgrads).max(axis=(1, 2))
    # the support surfaces' eikonal terms of both, from each side's gradients
    # at these points, without the weights: the samples' mean and the random
    # points' mean
    n_s = int(mask.sum())
    supp = [i for i in range(method.nr_surfs) if i != method.main_surf_idx]
    for name, g in (("port", grads), ("jax", jgrads)):
        err = (np.linalg.norm(g[:, supp].astype(np.float64), axis=-1) - 1.0) ** 2
        emit("eikonal_supp_terms", side=name, samples_mean=float(err[:n_s].mean()),
             random_points_mean=float(err[n_s:].mean()))
    worst = np.argsort(-diff)[:top]
    emit("points", points=len(pts), samples=int(mask.sum()),
         max_abs_sdf_diff=float(np.abs(sdfs - jsdfs).max()),
         max_abs_grad_diff=float(diff.max()),
         points_grad_diff_over_1e_3=int((diff > 1e-3).sum()),
         worst=[dict(index=int(i), random_point=bool(i >= int(mask.sum())),
                     point=pts[i].tolist(), grad_diff=float(diff[i]),
                     port_grad_norms=np.linalg.norm(grads[i], axis=-1).tolist(),
                     jax_grad_norms=np.linalg.norm(jgrads[i], axis=-1).tolist(),
                     port_sdfs=sdfs[i].tolist(), jax_sdfs=jsdfs[i].tolist())
                for i in worst])


def replay_steps(method, jmethod, batches, nr_rays, with_jax=True):
    """Each recorded step: the port's losses and gradients against JAX's
    (with_jax), and against the port's own with every parameter moved by
    one float32 ulp (a random sign each, the samples and draws kept): the
    float32 noise floor of those gradients at this state. Then the port's
    Adam step."""
    hp = method.hp
    S = hp.max_nr_samples_per_ray + hp.max_nr_imp_samples_per_ray
    n_imp = hp.max_nr_imp_samples_per_ray // 2
    start = method.iter_nr
    with warnings.catch_warnings():  # the schedule moved to the iteration without a step
        warnings.simplefilter("ignore")
        for _ in range(start):
            method.scheduler.step()
    results = []
    for k, full in enumerate(batches):
        it = start + k
        batch = {key: full[key][slice(nr_rays)] for key in ("rays_o", "rays_d", "gt_rgb", "gt_mask")}
        R = batch["rays_o"].shape[0]
        params = {name: flax_params(module) for name, module in method.models.items()}
        t = time.perf_counter()
        losses, got, samples = _port_step(method, batch, it,
                                          _draws(np.random.default_rng(100 + k), R, S, n_imp))
        port_s = time.perf_counter() - t
        grads = {n: p.grad.clone() for n, p in method.models.named_parameters()
                 if p.grad is not None}
        saved = {n: p.detach().clone() for n, p in method.models.named_parameters()}
        gen = torch.Generator().manual_seed(k)
        with torch.no_grad():
            for n, p in method.models.named_parameters():
                sign = torch.randint(0, 2, p.shape, generator=gen) * 2 - 1
                p.copy_(torch.nextafter(p, p + sign * torch.inf))
        _, moved, _ = _port_step(method, batch, it, _draws(
            np.random.default_rng(100 + k), R, S, n_imp, sampler=False), samples)
        with torch.no_grad():
            for n, p in method.models.named_parameters():
                p.copy_(saved[n])
                p.grad = grads.get(n)
        noise = _rel_err(moved, got)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(MLP, "_forward_with_tangents", _jax_tangents)
            _, jax_tangents, _ = _port_step(method, batch, it, _draws(
                np.random.default_rng(100 + k), R, S, n_imp, sampler=False), samples)
        with torch.no_grad():
            for n, p in method.models.named_parameters():
                p.grad = grads.get(n)
        tol = TOLERANCES[method.phase(it)]
        row = dict(step=k, iter_nr=it, phase=method.phase(it), rays=R,
                   losses={key: float(v.detach()) for key, v in losses.items()},
                   ulp_noise_rel_err=noise, port_s=port_s)
        if with_jax:
            t = time.perf_counter()
            ref_losses, ref = _jax_step(
                jmethod, method, params, batch, it,
                _draws(np.random.default_rng(100 + k), R, S, n_imp, sampler=False,
                       points=False), samples,
                _random_points(method, np.random.default_rng(100 + k), R, S, n_imp))
            row["jax_s"] = time.perf_counter() - t
            loss_err = {key: abs(float(losses[key].detach()) - float(ref_losses[key]))
                        / max(abs(float(ref_losses[key])), 1e-30) for key in ref_losses}
            err = _rel_err(got, ref)
            row["jax_tangents_grad_rel_err"] = _rel_err(jax_tangents, ref)
            row.update(
                loss_rel_err=loss_err, grad_rel_err=err,
                losses_over_tolerance=[key for key, e in loss_err.items() if e > tol["losses"]],
                grads_over_tolerance={key: [e, tol["grads"](key)] for key, e in err.items()
                                      if e > tol["grads"](key)},
                grads_over_noise={key: [e, noise[key]] for key, e in err.items()
                                  if e > NOISE_FACTOR * noise[key] and e > tol["grads"](key)})
            row["ok"] = not row["losses_over_tolerance"] and not row["grads_over_tolerance"]
            row["within_noise"] = (not row["losses_over_tolerance"]
                                   and not row["grads_over_noise"])
        emit("step", **row)
        results.append(row)
        for p in method.models.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        method.optimizer.step()
        method.scheduler.step()
        method.iter_nr = it + 1
    return results


def main():
    parser = argparse.ArgumentParser(__doc__)
    parser.add_argument("dip")
    # the run's schedule, for files that do not hold it (the first
    # experiment's: 1/25, 80 offsets-init steps)
    parser.add_argument("--scale", type=float, default=0.04)
    parser.add_argument("--offsets-init-steps", type=int, default=80)
    parser.add_argument("--clip", default="on", choices=("on", "off"))
    parser.add_argument("--rays", type=int, default=None,
                        help="the first N rays of each recorded batch (default: all)")
    parser.add_argument("--port-only", action="store_true",
                        help="the refresh and the ulp-noise control of the port alone")
    parser.add_argument("--points", action="store_true",
                        help="after the port's refresh, the first step's points through "
                             "both packages' SDFs with grads (JAX's plain and under "
                             "autodiff), instead of the steps")
    args = parser.parse_args()
    torch.set_num_threads(4)
    JF._small_cumsum = _small_cumsum_keeping_empty(JF._small_cumsum)
    method, hp, cuts, meta, batches, grids = load(args.dip, dict(
        scale=args.scale, offsets_init_steps=args.offsets_init_steps, clip=args.clip == "on"))
    emit("state", meta=meta, cuts=cuts, batches=[b["rays_o"].shape[0] for b in batches],
         card_occupied_before=int(grids["grid_before"].sum()))
    if args.port_only:
        method.update_occupancy_grid()
        emit("refresh", port_card_differ=int(
            (method.grid.occupancy.numpy().reshape(-1) != grids["grid_after"]).sum()))
        replay_steps(method, None, batches, args.rays, with_jax=False)
        return 0
    jmethod = jax_method(hp)
    jparams = {name: flax_params(module) for name, module in method.models.items()}
    if args.points:  # the refresh is the port's alone here
        method.update_occupancy_grid()
        diagnose_points(method, jmethod, batches[0], args.rays)
        return 0
    refresh = replay_refresh(method, jmethod, jparams, grids["grid_after"])
    steps = replay_steps(method, jmethod, batches, args.rays)
    ok = refresh["ok"] and all(s["ok"] for s in steps)
    noise = refresh["ok"] and all(s["within_noise"] for s in steps)
    print(json.dumps({"replay_agrees": ok, "diagnostic_within_noise_factor": noise}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
