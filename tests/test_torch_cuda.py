"""The port's CUDA kernels against their plain versions, on the card.

Imports no JAX, so it runs on a machine without it:
``python -m pytest --noconftest -q tests/test_torch_cuda.py``. Without a
CUDA device every test skips."""

import os

import numpy as np
import pytest
import torch

from volsurfs_tpu_torch.baking.mesh_io import load_obj
from volsurfs_tpu_torch.datasets import baked_scene
from volsurfs_tpu_torch.datasets.cameras import get_camera_rays
from volsurfs_tpu_torch.datasets.mvdataset import MVDataset
from volsurfs_tpu_torch.ops import bvh as TB
from volsurfs_tpu_torch.ops import scatter_add as S
from volsurfs_tpu_torch.ops import shade as SH
from volsurfs_tpu_torch.renderers.mesh_renderer import BakedMeshRenderer, camera_rays
from volsurfs_tpu_torch.renderers.viewer import OrbitCamera

from _baked_uvs import edge_uvs
from _permuto_points import kinds_of_points

torch.set_num_threads(2)

MESH_DIR = os.path.join(
    os.path.dirname(__file__), "..", "runs", "pipeline_tpu_256", "volsurfs", "meshes"
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("nr_rows", [8, 355278])
def test_scatter_add_kernel_matches_plain(cuda, nr_rows):
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.integers(0, nr_rows, 100000).astype(np.int32)).to(cuda)
    upd = torch.from_numpy(rng.standard_normal((100000, 2)).astype(np.float32)).to(cuda)
    out = S.scatter_add_rows(rows, upd, nr_rows)
    ref = S.scatter_add_rows_reference(rows, upd, nr_rows)
    torch.cuda.synchronize()
    # atomics sum in another order than the plain version
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6 * (100000 / nr_rows + 1))


@pytest.mark.parametrize("nr_feat", [1, 2, 3])
def test_scatter_add_kernel_widths_drop_rows_out_of_range(cuda, nr_feat):
    """Each width (F=2 takes the float2 path, others one value a thread),
    with rows below 0 and at or past the table's end, which the kernel
    drops: it equals the plain version of the rows in range. The output
    comes from torch.empty, so the kernel must zero it."""
    rng = np.random.default_rng(nr_feat)
    nr_rows, M = 4096, 100000
    rows_np = rng.integers(-50, nr_rows + 50, M).astype(np.int32)
    rows = torch.from_numpy(rows_np).to(cuda)
    upd = torch.from_numpy(rng.standard_normal((M, nr_feat)).astype(np.float32)).to(cuda)
    # NaNs in the block that the caching allocator hands to the output next
    torch.full((nr_rows * nr_feat,), float("nan"), device=cuda)
    out = S.scatter_add_rows(rows, upd, nr_rows)
    keep = torch.from_numpy((rows_np >= 0) & (rows_np < nr_rows)).to(cuda)
    ref = S.scatter_add_rows_reference(rows[keep], upd[keep], nr_rows)
    torch.cuda.synchronize()
    assert out.shape == (nr_rows, nr_feat)
    # atomics sum in another order than the plain version
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6 * (M / nr_rows + 1))


def test_scatter_add_kernel_drops_out_of_range_like_plain(cuda):
    """The cases of the CPU tests in test_torch_scatter_add.py on the card:
    rows [0, 5, -1, 9] into 8 rows, and a level-0 index equal to nr_rows,
    give the plain version's result exactly (one addition per row)."""
    rows = torch.tensor([0, 5, -1, 9], dtype=torch.int32)
    upd = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0], [7.0, 8.0]])
    out = S.scatter_add_rows(rows.to(cuda), upd.to(cuda), 8)
    assert torch.equal(out.cpu(), S.scatter_add_rows_reference(rows, upd, 8))
    idx = torch.tensor([[8, 2, -1], [1, 3, 0]], dtype=torch.int32)
    lvl = torch.arange(12, dtype=torch.float32).reshape(2, 3, 2) + 1.0
    out = S.scatter_add_levels(idx.to(cuda), lvl.to(cuda), 8)
    assert torch.equal(out.cpu(), S.scatter_add_levels(idx, lvl, 8))
    assert float(out[1].sum()) == float(lvl[1].sum())


def test_scatter_add_rejects_wrong_dtype(cuda):
    with pytest.raises(ValueError):
        S.scatter_add_rows(torch.zeros(4, dtype=torch.int64, device=cuda),
                           torch.zeros(4, 2, device=cuda), 8)


@pytest.mark.parametrize("nr_rays", [512, 16384])
def test_bvh_trace_kernel_matches_plain(cuda, nr_rays):
    """K2 equals its plain version bit for bit, at the train step's ray
    count and at one render chunk's."""
    meshes = [load_obj(os.path.join(MESH_DIR, f"{i}.obj")) for i in range(5)]
    stacked = TB.stack_bvhs([TB.build_bvh(v, f) for v, f, _ in meshes], cuda)
    rng = np.random.default_rng(1)
    o = rng.standard_normal((nr_rays, 3))
    o = 2.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-0.6, 0.6, (nr_rays, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays_o = torch.from_numpy(o.astype(np.float32)).to(cuda)
    rays_d = torch.from_numpy(d.astype(np.float32)).to(cuda)
    out = TB.trace_all(stacked, rays_o, rays_d)
    ref = TB.trace_all_reference(stacked, rays_o, rays_d)
    stacked.check_step_cap()
    assert int(stacked.step_cap.count.item()) == 0
    for key in ("is_hit", "depth", "positions", "barycentric", "triangles_id"):
        assert torch.equal(out[key], ref[key]), key
    assert 0.2 < float(out["is_hit"].float().mean()) < 0.95


def test_bvh_trace_kernel_culled_matches_plain(cuda):
    """K2 with back-face culling equals its plain version bit for bit: the
    committed shells' own signs on four of them and 0 (no culling) on one,
    from a camera outside them, and sign -1 (back faces only) from the same
    camera."""
    r = BakedMeshRenderer(baked_scene.COMMITTED_SCENE, device=cuda)
    cam = MVDataset("synthetic", "sphere", "", splits=("test",),
                    config={"width": 128, "height": 128})["test"].cameras[0]
    assert r.cameras_outside([cam])
    intr, poses = r.camera_tensors([cam])
    rays_o, rays_d = camera_rays(intr[0], poses[0], 128, 128)
    own = r.cull_signs.clone()
    own[2] = 0
    for cull in (own, -r.cull_signs):
        out = TB.trace_all(r.stacked_bvh, rays_o, rays_d, cull)
        ref = TB.trace_all_reference(r.stacked_bvh, rays_o, rays_d, cull)
        for key in ("is_hit", "depth", "positions", "barycentric", "triangles_id"):
            assert torch.equal(out[key], ref[key]), key
        assert 0.05 < float(out["is_hit"].float().mean()) < 0.95
    r.stacked_bvh.check_step_cap()


# K4 against its plain version: the two sum the SH terms in other orders, so
# a float16 SH value may round one step apart, which moves an output by a few
# float16 steps of [0, 1] (4.9e-4 each); almost every entry is equal
K4_ATOL = 2e-3
K4_MAX_DIFFER = 1e-3  # share of entries that may differ at all


def _assert_shade_close(out, ref):
    for key in ("rgb", "bg_transmittance"):
        assert out[key].shape == ref[key].shape, key
        diff = (out[key] - ref[key]).abs()
        assert bool(torch.isfinite(out[key]).all()), key
        assert float(diff.max()) <= K4_ATOL, (key, float(diff.max()))
        assert float((diff > 0).float().mean()) <= K4_MAX_DIFFER, key


def test_shade_kernel_matches_plain_committed_scene(cuda):
    """K4 on K2's hits of a 256x256 test camera of the committed scene
    (5 shells, sh_degree 2), against the plain version on the card."""
    r = BakedMeshRenderer(baked_scene.COMMITTED_SCENE, device=cuda)
    cam = MVDataset("synthetic", "sphere", "", splits=("test",),
                    config={"width": 256, "height": 256})["test"].cameras[0]
    intr, poses = r.camera_tensors([cam])
    rays_o, rays_d = camera_rays(intr[0], poses[0], cam.width, cam.height)
    _, tri, u, v = TB.trace_all_buffers(r.stacked_bvh, rays_o, rays_d)
    hits = SH.hits_from_buffers(tri, u, v, r.nr_meshes)
    args = r.shade_inputs(hits, rays_d)
    out = SH.shade_composite_buffers(tri, u, v, *args[1:])
    ref = SH._shade_composite_reference(*args)
    torch.cuda.synchronize()
    assert 0.2 < float(hits["is_hit"].float().mean()) < 0.95
    _assert_shade_close(out, ref)


def test_shade_kernel_matches_plain_edges_sh3(cuda, tmp_path):
    """K4 on a sh_degree 3 scene (two shells, mesh 0 ignores alpha) at uvs on
    texture edges, outside [0, 1] and on texel centres: each hit is face 0
    of a one-face UV table whose vertex UVs are (0, 0), (1, 0), (0, 1), so
    that the barycentrics are the uv; a fifth of the hits are misses."""
    res = (16, 8, 4, 2)
    baked_scene.write_random_scene(str(tmp_path), baked_scene.committed_mesh_files()[:2], res, 3,
                                   seed=3)
    r = BakedMeshRenderer(str(tmp_path), device=cuda)
    u, v = edge_uvs(res, 4000, seed=4)
    N = u.shape[0]
    rng = np.random.default_rng(5)
    d = rng.standard_normal((N, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    bary = np.stack([u, v], -1).astype(np.float32)
    tri = torch.from_numpy(np.where(rng.uniform(size=2 * N) > 0.2, 0, -1).astype(np.int32))
    bary2 = torch.from_numpy(np.stack([bary, bary[::-1].copy()]))  # [2, N, 2]
    tri, uu, vv = (x.contiguous().to(cuda) for x in (tri, bary2[..., 0], bary2[..., 1]))
    uu, vv = uu.view(-1), vv.view(-1)
    hits = SH.hits_from_buffers(tri, uu, vv, 2)
    face_uv = torch.tensor([[0.0, 0.0, 1.0, 0.0, 0.0, 1.0]], device=cuda)
    face_offsets = torch.zeros(2, dtype=torch.int64, device=cuda)
    rays_d = torch.from_numpy(d.astype(np.float32)).to(cuda)
    args = (face_uv, face_offsets, rays_d, r.band_textures, r.ignore_alpha_flags, r.bg_color,
            r.sh_degree)
    out = SH.shade_composite_buffers(tri, uu, vv, *args)
    ref = SH._shade_composite_reference(hits, *args)
    torch.cuda.synchronize()
    _assert_shade_close(out, ref)


@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
def test_shade_kernel_tiled_matches_plain_ragged_frame(cuda, tmp_path, sh_degree):
    """K4 in 16x8 pixel tiles on a 37x23 frame (neither side a multiple of
    the tile) of three shells at each SH degree, on K2's culled buffers: it
    equals K4 over the rays in order (width 0) bit for bit, and its plain
    version (on trace_all's dict) within K4_ATOL."""
    baked_scene.write_random_scene(str(tmp_path), baked_scene.committed_mesh_files()[:3],
                                   (64, 32, 16, 8), sh_degree, seed=sh_degree)
    r = BakedMeshRenderer(str(tmp_path), device=cuda)
    oc = OrbitCamera(37, 23, radius=1.6)
    oc.azimuth = 0.7
    cam = oc.camera()
    intr, poses = r.camera_tensors([cam])
    rays_o, rays_d = camera_rays(intr[0], poses[0], 37, 23)
    cull = r.frame_cull([cam])
    _, tri, u, v = TB.trace_all_buffers(r.stacked_bvh, rays_o, rays_d, cull)
    rest = (r.face_uv, r.face_offsets, rays_d, r.band_textures, r.ignore_alpha_flags,
            r.bg_color, r.sh_degree)
    tiled = SH.shade_composite_buffers(tri, u, v, *rest, width=37)
    linear = SH.shade_composite_buffers(tri, u, v, *rest)
    hits = TB.trace_all(r.stacked_bvh, rays_o, rays_d, cull)
    ref = SH._shade_composite_reference(hits, *rest)
    torch.cuda.synchronize()
    for key in ("rgb", "bg_transmittance"):
        assert torch.equal(tiled[key], linear[key]), key
    assert 0.1 < float(hits["is_hit"].float().mean()) < 0.95
    _assert_shade_close(tiled, ref)
    r.stacked_bvh.check_step_cap()


def _half_pairs(rng, n_random):
    """float16 operand pairs (a, b): n_random random finite ones; every
    byte 0-255 times every float16 weight in [0, 1]; and every pair of edge
    values (zeros, subnormals, the smallest normal, +-65504, values whose
    sums and products fall on ties)."""
    bits = rng.integers(0, 1 << 16, (2, n_random), dtype=np.uint16)
    bits = np.where((bits & 0x7C00) == 0x7C00, bits & 0x83FF, bits)  # no inf or NaN
    a, b = bits.view(np.float16)
    byte = np.repeat(np.arange(256, dtype=np.float16), 0x3C01)
    weight = np.tile(np.arange(0x3C01, dtype=np.uint16).view(np.float16), 256)
    edges = np.array([0x0000, 0x8000, 0x0001, 0x8001, 0x0002, 0x03FF, 0x83FF, 0x0400, 0x8400,
                      0x3C00, 0xBC00, 0x3C01, 0x3BFF, 0x1000, 0x0E00, 0x1400, 0x3800, 0x6400,
                      0x6800, 0x5BF8, 0x7BFF, 0xFBFF, 0x7BFE, 0x4000, 0x4200, 0x0200],
                     np.uint16).view(np.float16)
    ea, eb = np.meshgrid(edges, edges, indexing="ij")
    a = np.concatenate([a, byte, ea.reshape(-1)])
    b = np.concatenate([b, weight, eb.reshape(-1)])
    n = a.shape[0] - a.shape[0] % 2
    return a[:n], b[:n]


def test_half_ops_match_float32_rounding(cuda):
    """K4's float16 arithmetic: the half2 and half _rn products, sums and
    differences equal the float32 ones rounded to float16, bit for bit, on
    10^7 random pairs, every texel byte times every weight in [0, 1] and
    the edge values; and K4's products of the four bytes of a texel word
    with a weight (a byte under the exponent of 1024, one fma) equal the
    rounded float32 products wherever a is a byte and b a weight."""
    a_np, b_np = _half_pairs(np.random.default_rng(9), 10_000_000)
    a, b = torch.from_numpy(a_np).to(cuda), torch.from_numpy(b_np).to(cuda)
    native, rounded, texel = SH.half_ops_check(a, b)
    torch.cuda.synchronize()
    for row, name in enumerate(("h2mul", "h2add", "h2sub", "hmul", "hadd", "hsub")):
        same = native[row].view(torch.int16) == rounded[row % 3].view(torch.int16)
        assert bool(same.all()), (name, int((~same).sum()))
    af = a.float()
    # sign bits clear: K4's texel bytes and weights are never -0
    byte_weight = ((af == af.round()) & (a.view(torch.int16) >= 0) & (af <= 255)
                   & (b.view(torch.int16) >= 0) & (b <= 1))
    assert int(byte_weight.sum()) >= 256 * 0x3C01
    for row in range(4):
        same = texel[row].view(torch.int16) == rounded[0].view(torch.int16)
        assert bool(same[byte_weight].all()), (row, int((~same[byte_weight]).sum()))


def test_baked_renderer_frame_entry_points_agree(cuda):
    """render() in 65,536-ray chunks equals render_rays on get_camera_rays'
    rays with no culling, as JAX's render traces; render_frame equals
    render_rays on camera_rays' rays with the frame's cull signs, and one
    frame of render_frames_device, whose overflow is zero."""
    r = BakedMeshRenderer(baked_scene.COMMITTED_SCENE, device=cuda)
    cam = MVDataset("synthetic", "sphere", "", splits=("test",),
                    config={"width": 256, "height": 256})["test"].cameras[1]
    rays_o, rays_d = (torch.from_numpy(x).to(cuda) for x in get_camera_rays(cam))
    unculled = r.render_rays(rays_o, rays_d)["rgb"].reshape(256, 256, 3).cpu().numpy()
    assert np.array_equal(r.render(cam, chunk_size=65536), unculled)
    frame = r.render_frame(cam)
    intr, poses = r.camera_tensors([cam])
    culled = r.render_rays(*camera_rays(intr[0], poses[0], 256, 256), r.frame_cull([cam]))
    assert np.array_equal(culled["rgb"].reshape(256, 256, 3).cpu().numpy(), frame)
    imgs, overflow = r.render_frames_device([cam, cam])
    assert imgs.is_cuda and imgs.shape == (2, 256, 256, 3)
    assert np.array_equal(imgs[1].cpu().numpy(), frame)
    assert overflow.tolist() == [0, 0, 0]
    r.stacked_bvh.check_step_cap()


def test_volsurfs_stage_on_the_card(cuda, tmp_path):
    """tests/test_volsurfs_e2e.py's configuration (sh_degree 1, 64^2
    textures, 128 rays a step; tests/_stage_config.py) on the five committed
    shells (the card has no JAX to build the test's own): 5 Trainer steps,
    a bake, a reload. The baked render lies within a mean 0.15 of the
    neural render on the test cameras, and the path launched K1, K2 and K4
    and no plain version."""
    from volsurfs_tpu_torch.baking import baker
    from volsurfs_tpu_torch.datasets import sphere_scene
    from volsurfs_tpu_torch.methods.volsurfs import VolSurfs
    from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
    from volsurfs_tpu_torch.params.hyper_params import HyperParamsVolSurfs
    from volsurfs_tpu_torch.training.trainer import Trainer

    from _stage_config import DATA, HP

    for counts in (S.launches, TB.launches, SH.launches):
        for key in counts:
            counts[key] = 0
    hp = HyperParamsVolSurfs(**HP)
    mv = MVDataset("synthetic", "sphere", "", config=DATA)
    method = VolSurfs(hp, sphere_scene.load_shells(), bg_color="white",
                      bounding_primitive=make_bounding_sphere(1.0), device=cuda)
    trainer = Trainer(method, mv, str(tmp_path))
    trainer.train(end_iter=5)
    files = sorted(f for f in os.listdir(MESH_DIR) if f.endswith(".obj"))
    baker.copy_meshes_renumbered(MESH_DIR, files, str(tmp_path))
    info = baker.bake_textures(method, str(tmp_path))
    baker.export_scene_json(str(tmp_path), info, mv, bg_color="white", sh_degree=hp.sh_degree)
    renderer = BakedMeshRenderer(str(tmp_path), device=cuda)
    for cam in mv["test"].cameras:
        baked = renderer.render(cam)
        neural = trainer.render_camera(cam)["rgb"].clip(0, 1)
        assert np.isfinite(baked).all() and baked.shape == neural.shape
        assert np.abs(baked - neural).mean() < 0.15
    counts = {**S.launches, **TB.launches, **SH.launches}
    assert counts["scatter_add"] > 0 and counts["bvh_trace"] > 0 and counts["shade"] > 0
    assert counts["scatter_add_reference"] == counts["bvh_trace_reference"] == 0
    assert counts["shade_reference"] == 0


def _permuto_inputs(device, n, seed=0, kind=None, **encoder):
    """A PermutoEncoder on device with a table of uniform(-0.5, 0.5) rows,
    and n points: uniform in the box, a few outside it, and a few at the
    invalid samples' depth (1e10); or with ``kind`` about n points of that
    kind (``_permuto_points.kinds_of_points``)."""
    from volsurfs_tpu_torch.models.encodings import PermutoEncoder

    rng = np.random.default_rng(seed)
    enc = PermutoEncoder(**encoder).to(device)
    with torch.no_grad():
        enc.table.copy_(torch.from_numpy(
            rng.uniform(-0.5, 0.5, tuple(enc.table.shape)).astype(np.float32)))
    if kind is None:
        pts = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
        pts[:64] *= 1.5
        pts[64:80] = 1e10
    else:
        pts = kinds_of_points(rng, kind, n)
    unit = (torch.from_numpy(pts).to(device) / enc.half_sides + 1.0) / 2.0
    return enc, unit.contiguous(), rng


def _check_permuto_forward(enc, unit, with_grad):
    """The forward kernel against its plain version: feats and dfeats bit
    for bit. Returns the plain version's rows, weights and rank codes."""
    from volsurfs_tpu_torch.ops import permuto as P

    args = (unit, enc.table.detach(), enc.W, enc.level_sizes, enc.level_offsets,
            enc.ddiff if with_grad else None)
    got = P.permuto_forward(*args)
    ref = P.permuto_forward_reference(*args)
    for name, a, b in zip(("feats", "dfeats"), got, ref[:2]):
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), (name, int((a != b).sum()))
    return ref[2:]


def _check_permuto_backward(enc, unit, rng, with_grad, plain_rows, masked=None):
    """The fused backward kernel (rows and weights recomputed from the
    points) against its plain version: the points' gradient bit for bit
    (the same sums in the same order); the table gradient within 1e-5 of
    the absolute sum of each row's updates (the atomics sum them in another
    order). plain_rows: the plain forward's (idx, bary, code)."""
    from volsurfs_tpu_torch.ops import permuto as P

    n, L = unit.shape[0], enc.nr_levels
    ddiff = enc.ddiff if with_grad else None
    table = enc.table.detach()
    dout = torch.from_numpy(rng.standard_normal((n, 2 * L)).astype(np.float32)).to(unit.device)
    gd = None
    if with_grad:
        gd = torch.from_numpy(rng.standard_normal((3, n, 2 * L)).astype(np.float32)).to(
            unit.device)
    if masked is not None:  # the cotangents a loss gives samples it masks
        dout[masked] = 0.0
        if gd is not None:
            gd[:, masked] = 0.0
    args = (unit, table, enc.W, enc.level_sizes, enc.level_offsets, dout, ddiff, gd)
    idx, bary, code = plain_rows
    upd, d_unit_ref = P.permuto_backward_reference(idx, bary, code, dout, ddiff, gd, table, enc.W)
    d_ref = S.scatter_add_rows_reference(idx.reshape(-1), upd, enc.total_rows)
    bound = S.scatter_add_rows_reference(idx.reshape(-1), upd.abs(), enc.total_rows)
    got = P.permuto_backward(*args, want_unit=True)
    table_only, none = P.permuto_backward(*args)
    none_table, unit_only = P.permuto_backward(*args, want_table=False, want_unit=True)
    torch.cuda.synchronize()
    assert none is None and none_table is None
    assert torch.equal(got[1], d_unit_ref), int((got[1] != d_unit_ref).sum())
    assert torch.equal(unit_only, d_unit_ref)
    for d_table in (got[0], table_only):
        assert bool(((d_table - d_ref).abs() <= 1e-5 * bound + 1e-7).all())
    return got


@pytest.mark.parametrize("with_grad", [False, True])
@pytest.mark.parametrize("n", [30000, 49152, 65536])
def test_permuto_kernel_matches_plain(cuda, with_grad, n):
    """K6 against its plain versions at the sphere-init, data-step and
    occupancy-refresh shapes: feats and dfeats bit for bit (the same
    operations in the same order, no contraction); the fused backward's
    points' gradient bit for bit and its table gradient to the atomics'
    summation order."""
    enc, unit, rng = _permuto_inputs(cuda, n)
    plain_rows = _check_permuto_forward(enc, unit, with_grad)
    _check_permuto_backward(enc, unit, rng, with_grad, plain_rows)


@pytest.mark.parametrize("nr_levels", [24, 4])
@pytest.mark.parametrize("n", [1, 33, 49151])
def test_permuto_forward_kernel_ragged_tiles(cuda, nr_levels, n):
    """The forward at point counts that leave the last block part full (a
    block is 256 (point, level) threads) and at few levels: feats and dfeats
    bit for bit, with and without grads."""
    enc, unit, _ = _permuto_inputs(cuda, n, seed=n, nr_levels=nr_levels)
    for with_grad in (False, True):
        _check_permuto_forward(enc, unit, with_grad)


@pytest.mark.parametrize("nr_levels", [24, 4])
def test_permuto_backward_kernel_ragged_tiles(cuda, nr_levels):
    """The fused backward at point counts that leave a tile part full and
    at few levels (fewer slots than a block has warps), with and without
    grads."""
    for n in (1, 33, 4099):
        enc, unit, rng = _permuto_inputs(cuda, n, seed=n, nr_levels=nr_levels)
        for with_grad in (False, True):
            plain_rows = _check_permuto_forward(enc, unit, with_grad)
            _check_permuto_backward(enc, unit, rng, with_grad, plain_rows)


@pytest.mark.parametrize("kind", ["ball", "refresh", "outside"])
def test_permuto_backward_kernel_kinds_of_points(cuda, kind):
    """The backward's rows and weights, recomputed from the points, at the
    surf stage's kinds of points (samples in the bounding ball with 16 at
    the invalid samples' depth 1e10, voxel centres, points outside the
    box): its results hold against the plain version, which takes the plain
    forward's rows and weights."""
    enc, unit, rng = _permuto_inputs(cuda, 4096, seed=7, kind=kind)
    plain_rows = _check_permuto_forward(enc, unit, True)
    _check_permuto_backward(enc, unit, rng, True, plain_rows)


def test_permuto_backward_kernel_zero_cotangents(cuda):
    """Samples with zero cotangents (a ray's unused samples, the points at
    1e10 among them, which all hash to the same rows) add nothing to the
    table's gradient: the kernel skips their updates, and the result still
    matches the plain version, which adds the zeros."""
    enc, unit, rng = _permuto_inputs(cuda, 49152)
    masked = torch.zeros(49152, dtype=torch.bool, device=cuda)
    masked[64:80] = True
    masked[::3] = True
    plain_rows = _check_permuto_forward(enc, unit, True)
    d_table, _ = _check_permuto_backward(enc, unit, rng, True, plain_rows, masked=masked)
    assert bool(d_table.any())


def _refreshed_grid(device, res=256, extent=2.0):
    """A grid at the surf stage's shape after a refresh: |sdf| of a sphere
    of radius 0.4, occupancy from the logistic density at beta 20."""
    from volsurfs_tpu_torch.ops.occupancy import make_grid

    grid = make_grid(res, extent, sphere_roi_radius=extent / 2, device=device)
    centers = grid.voxel_centers()
    grid = grid.update_values(torch.abs(torch.linalg.norm(centers, dim=-1) - 0.4))
    return grid.update_occupancy_with_sdf(20.0)


@pytest.mark.parametrize("extent", [2.0, 3.0])
@pytest.mark.parametrize("nr_rays", [512, 16384])
@pytest.mark.parametrize("clip", [False, True])
def test_occupancy_sampler_kernel_matches_plain(cuda, nr_rays, clip, extent):
    """K7 against its plain version on a refreshed 256^3 grid, for rays
    from a sphere around the scene, some missing it: z, mask, the clipped
    interval and the spacing bit for bit, on a grid spanning 2 (the
    kernels that multiply by the exact reciprocal) and 3 (the kernel that
    divides)."""
    from volsurfs_tpu_torch.ops import samplers as SP
    from volsurfs_tpu_torch.ops.raycast import intersect_bounding_primitive, make_bounding_sphere

    rng = np.random.default_rng(nr_rays)
    grid = _refreshed_grid(cuda, extent=extent)
    o = rng.standard_normal((nr_rays, 3)).astype(np.float32)
    o = 2.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + 0.6 * rng.standard_normal((nr_rays, 3)).astype(np.float32)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    rays_o, rays_d = torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)
    rc = intersect_bounding_primitive(make_bounding_sphere(1.0), rays_o, rays_d)
    jitter = torch.from_numpy(rng.uniform(0, 1, (nr_rays, 1)).astype(np.float32)).to(cuda)
    args = (rays_o, rays_d, rc["t_near"].contiguous(), rc["t_far"].contiguous(), grid, jitter,
            1e-4, 3, 64, 512, 512 if clip else 0)
    got = SP.occupancy_samples(*args)
    ref = SP.occupancy_samples_reference(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("z", "mask", "t_near", "t_far", "const_dist"), got, ref):
        assert torch.equal(a, b), (name, int((a != b).sum()))
    assert int(got[1].sum()) > nr_rays  # the rays that hit the sphere took samples


@pytest.mark.parametrize("R", [1024, 4096])
@pytest.mark.parametrize("nr_march", [32, 512, 2048])
@pytest.mark.parametrize("nr_probe", [0, 512])
def test_occupancy_sampler_kernel_edge_rays(cuda, nr_probe, nr_march, R):
    """K7 on a thin shell (|sdf| of a sphere of radius 0.4 at beta 200): rays
    from the centre whose whole interval lies in the shell, rays whose
    interval holds no occupied voxel (inside the shell, or outside the grid),
    rays with t_near == t_far, and rays through the sphere, at both probe
    counts and march lengths from one run of 32 steps to the longest, with
    four warps a ray (1,024 rays) and a warp a ray (4,096): z, mask, the
    clipped interval and the spacing bit for bit."""
    from volsurfs_tpu_torch.ops import samplers as SP
    from volsurfs_tpu_torch.ops.occupancy import make_grid

    grid = make_grid(256, 2.0, sphere_roi_radius=1.0, device=cuda)
    grid = grid.update_values(torch.abs(torch.linalg.norm(grid.voxel_centers(), dim=-1) - 0.4))
    grid = grid.update_occupancy_with_sdf(200.0)
    rng = np.random.default_rng(nr_probe + nr_march + R)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.zeros((R, 3), np.float32)
    t = rng.uniform(0.0, 1.0, (R, 2)).astype(np.float32)
    kinds = np.arange(R) % 5
    spans = {0: (0.38, 0.42), 1: (0.0, 0.2), 2: (3.0, 4.0), 3: (0.4, 0.4)}
    for kind, (lo, hi) in spans.items():
        t[kinds == kind] = (lo, hi)
    through = kinds == 4  # from a sphere of radius 2 towards the centre
    o[through] = -2.0 * d[through]
    t[through] = (1.0, 3.0)
    tn, tf = (torch.from_numpy(np.ascontiguousarray(t[:, i:i + 1])).to(cuda) for i in (0, 1))
    jitter = torch.from_numpy(rng.uniform(0, 1, (R, 1)).astype(np.float32)).to(cuda)
    args = (torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda), tn, tf, grid, jitter,
            1e-4, 3, 64, nr_march, nr_probe)
    got = SP.occupancy_samples(*args)
    ref = SP.occupancy_samples_reference(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("z", "mask", "t_near", "t_far", "const_dist"), got, ref):
        assert torch.equal(a, b), (name, int((a != b).sum()))
    taken = got[1].sum(dim=1).cpu().numpy()
    assert (taken[kinds == 0] == 64).all() and (taken[(kinds == 1) | (kinds == 2)] == 0).all()
    assert (taken[kinds == 3] == 0).all() and taken[through].sum() > 0


def test_surf_steps_on_the_card(cuda, tmp_path):
    """The surf configuration of tests/_stage_config.py for 64 steps (the
    sphere-init phase and the data phase, two occupancy refreshes) through
    Trainer.train, then a render of a test camera: finite losses and frame,
    and the path launched K6 (forward and backward) and K7, no plain
    version, and not K1 (K6's backward accumulates the table's gradient
    itself)."""
    from volsurfs_tpu_torch.methods.surf import Surf
    from volsurfs_tpu_torch.ops import permuto as P
    from volsurfs_tpu_torch.ops import samplers as SP
    from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
    from volsurfs_tpu_torch.params.hyper_params import HyperParamsSuRF
    from volsurfs_tpu_torch.training.trainer import Trainer

    from _stage_config import SURF_DATA, SURF_HP, SURF_INIT_SPHERE_RADIUS, SURF_OCCUPANCY_RES

    for counts in (S.launches, P.launches, SP.launches):
        for key in counts:
            counts[key] = 0
    hp = HyperParamsSuRF(**SURF_HP)
    mv = MVDataset("synthetic", "sphere", "", config=SURF_DATA)
    method = Surf(hp, make_bounding_sphere(1.0), bg_color="white",
                  init_sphere_radius=SURF_INIT_SPHERE_RADIUS, occupancy_res=SURF_OCCUPANCY_RES,
                  device=cuda)
    trainer = Trainer(method, mv, str(tmp_path))
    losses = []
    trainer.train(end_iter=64, callback=lambda it, m, l: losses.append(float(l["loss"])))
    assert np.isfinite(losses).all() and losses[59] < losses[0]
    out = trainer.render_camera(mv["test"].cameras[0])
    assert out["rgb"].shape == (32, 32, 3) and np.isfinite(out["rgb"]).all()
    counts = {**S.launches, **P.launches, **SP.launches}
    assert min(counts["permuto_fwd"], counts["permuto_bwd"], counts["occupancy_sampler"]) > 0
    assert counts["scatter_add"] == 0, counts
    assert not any(v for k, v in counts.items() if k.endswith("_reference")), counts


# ---- K8: combine, the transmittance scan and importance sampling -----------


def _combine_outputs(samples, values):
    return (samples.z, samples.mask, samples.dt, samples.max_dt) + (
        () if values is None else (values,))


def _check_k8(kind, got, ref):
    from volsurfs_tpu_torch import kernel_bench as kb

    torch.cuda.synchronize()
    result = kb.k8_check(kind, got, ref)
    assert result["ok"], (kind, result)
    return result


@pytest.mark.parametrize("K", [1, 5])
def test_combine_kernel_matches_plain_bit_for_bit(cuda, K):
    """K8a at the three merges of a surf (K = 1, 512 rays) and an
    offsets_surfs (K = 5, 2,048 rays) data step, with equal and near-equal
    depths and empty rows (kernel_bench.k8_cases): every output bit for
    bit."""
    from volsurfs_tpu_torch import kernel_bench as kb
    from volsurfs_tpu_torch.ops import samples as TS

    for merge, (a, b, va, vb) in kb.k8_cases(cuda, K)["combine"].items():
        got = TS.combine(a, b, 1e-4, va, vb)
        ref = TS.combine_reference(a, b, 1e-4, va, vb)
        _check_k8("combine", _combine_outputs(*got), _combine_outputs(*ref))


def test_combine_kernel_edge_rows(cuda):
    """K8a on rows of one depth repeated, of samples all within the minimum
    distance, of one sample, of none on either side, and on a row longer
    than the static shared memory of 32 rays holds (fewer threads a block):
    bit for bit."""
    from volsurfs_tpu_torch import kernel_bench as kb
    from volsurfs_tpu_torch.ops import samples as TS

    rng = np.random.default_rng(3)
    for Sa, Sb in ((8, 8), (200, 100)):
        count_a = rng.integers(0, Sa + 1, (64, 1))
        count_a[:4] = [[0], [1], [Sa], [Sa]]
        a = kb.k8_samples(cuda, rng, 64, Sa, count_a)
        b = kb.k8_samples(cuda, rng, 64, Sb, rng.integers(0, Sb + 1, (64, 1)))
        za, zb = a.z.clone(), b.z.clone()
        za[2] = torch.where(a.mask[2], 1.5, za[2])  # one depth repeated
        zb[2] = torch.where(b.mask[2], 1.5, zb[2])
        za[3] = torch.where(a.mask[3], 1.5 + 1e-6 * torch.arange(Sa, device=cuda), za[3])
        a, b = TS.update_dt(a.replace(z=za)), TS.update_dt(b.replace(z=zb))
        va = torch.randn(64, Sa, 3, device=cuda)
        vb = torch.randn(64, Sb, 3, device=cuda)
        got = TS.combine(a, b, 1e-4, va, vb)
        ref = TS.combine_reference(a, b, 1e-4, va, vb)
        _check_k8("combine", _combine_outputs(*got), _combine_outputs(*ref))


def _combine_rows(device, rng, R, Sa, Sb, kind):
    """Sample sets a and b of R rays (kernel_bench.k8_samples: sorted valid
    prefixes, every 16th ray empty) made into kind: "sorted" as drawn;
    "unsorted", each set's depths shuffled within its row; "holes", masks
    with valid slots after invalid ones; "ties", b's depths copies of a's
    in the same slots or a slot apart (the merged row a run of equal pairs
    across the 128-slot tiles' edges)."""
    from volsurfs_tpu_torch import kernel_bench as kb
    from volsurfs_tpu_torch.ops import samples as TS

    a, b = kb.k8_samples(device, rng, R, Sa), kb.k8_samples(device, rng, R, Sb)
    za, zb, ma, mb = a.z.clone(), b.z.clone(), a.mask.clone(), b.mask.clone()
    if kind == "unsorted":
        za = za[:, torch.randperm(Sa, device=device)] if Sa else za
        zb = zb[:, torch.randperm(Sb, device=device)] if Sb else zb
        ma = torch.ones_like(ma)
        mb = torch.ones_like(mb)
        ma[1::3], mb[2::3] = a.mask[1::3], b.mask[2::3]
    elif kind == "holes":
        ma = torch.from_numpy(rng.uniform(0, 1, (R, Sa)) < 0.6).to(device)
        mb = torch.from_numpy(rng.uniform(0, 1, (R, Sb)) < 0.6).to(device)
    elif kind == "ties":  # Sa > Sb
        even = torch.arange(R, device=device)[:, None] % 2 == 0
        zb = torch.where(even, za[:, :Sb], za[:, 1:Sb + 1])
        mb = torch.where(even, ma[:, :Sb], ma[:, 1:Sb + 1])
    return TS.update_dt(a.replace(z=za, mask=ma)), TS.update_dt(b.replace(z=zb, mask=mb))


@pytest.mark.parametrize("C", [0, 1, 5, 16])
@pytest.mark.parametrize("S", [33, 96, 97, 300])
def test_combine_kernel_rows(cuda, S, C):
    """K8a at S = Sa + Sb slots on either side of the warp layout's chunks
    and tiles, carrying C values a slot (staged in shared memory in 16- or
    4-byte copies, or, at 300 x 16, read from device memory), on sorted
    rows, rows unsorted within a and within b (ranked by counting), rows
    with holes in their masks, and rows where a and b share exact depths
    across tile edges: every output bit for bit against the plain
    version."""
    from volsurfs_tpu_torch.ops import samples as TS

    Sa = {33: 17, 96: 64, 97: 64, 300: 200}[S]
    rng = np.random.default_rng(S + C)
    torch.manual_seed(S + C)
    R = 256
    for kind in ("sorted", "unsorted", "holes", "ties"):
        a, b = _combine_rows(cuda, rng, R, Sa, S - Sa, kind)
        va = torch.randn(R, Sa, C, device=cuda) if C else None
        vb = torch.randn(R, S - Sa, C, device=cuda) if C else None
        got = TS.combine(a, b, 1e-4, va, vb)
        ref = TS.combine_reference(a, b, 1e-4, va, vb)
        _check_k8("combine", _combine_outputs(*got), _combine_outputs(*ref))


@pytest.mark.parametrize("K", [1, 5])
def test_transmittance_kernel_matches_plain_autograd(cuda, K):
    """K8b on [K x R, 96] rows whose alphas reach 1 (R the path's rays,
    kernel_bench.K8_RAYS): the forward's weights, transmittance and
    background transmittance, and the backward from cotangents on all
    three, against the plain version under autograd (kernel_bench.k8_check's
    tolerances)."""
    from volsurfs_tpu_torch import kernel_bench as kb

    _check_transmittance(*kb.k8_cases(cuda, K)["transmittance"])


def _check_transmittance(alpha, mask):
    """K8b's forward and its backward from cotangents on all three outputs
    against the plain version under autograd."""
    from volsurfs_tpu_torch.ops import volume_rendering as VR

    dev = alpha.device
    cot = [torch.randn(alpha.shape, device=dev), torch.randn(alpha.shape, device=dev),
           torch.randn(alpha.shape[0], 1, device=dev)]
    outs, grads = [], []
    for fn in (VR.neus_transmittance, VR.neus_transmittance_reference):
        a = alpha.clone().requires_grad_(True)
        out = fn(a, mask)
        sum(torch.sum(o * c) for o, c in zip(out, cot)).backward()
        outs.append(tuple(o.detach() for o in out))
        grads.append((a.grad,))
    _check_k8("transmittance_fwd", *outs)
    _check_k8("transmittance_bwd", *grads)


def _transmittance_edge_rows(device, S, R=96, seed=0):
    """[R, S] alphas in [0, 0.4) with 5% at 1, and prefix masks: rows of 0,
    1 and S valid samples, the rest of random counts; a quarter of the rows
    with a run of 12 alphas of 1 from their second sample, whose products
    underflow T to 0."""
    rng = np.random.default_rng(seed + S)
    alpha = rng.uniform(0.0, 0.4, (R, S)).astype(np.float32)
    alpha[rng.uniform(0, 1, alpha.shape) < 0.05] = 1.0
    alpha[::4, 1:13] = 1.0
    count = rng.integers(0, S + 1, (R, 1))
    count[:6] = [[0], [1], [S], [0], [1], [S]]
    mask = np.arange(S)[None, :] < count
    return (torch.from_numpy(alpha).to(device), torch.from_numpy(mask).to(device))


@pytest.mark.parametrize("S", [1, 31, 32, 33, 96, 97, 300])
def test_transmittance_kernel_edge_rows(cuda, S):
    """K8b at row lengths on either side of the warp layout's 32-sample
    chunks and 128-sample tiles (the scans' carries), on rows of 0, 1 and
    S valid samples and runs of alpha = 1 that underflow T: forward and
    backward against the plain version (kernel_bench.k8_check's
    tolerances)."""
    torch.manual_seed(S)
    _check_transmittance(*_transmittance_edge_rows(cuda, S))


@pytest.mark.parametrize("K", [1, 5])
def test_importance_kernel_matches_plain(cuda, K):
    """K8c at both rounds of a data step (64 and 80 samples, 16 new depths,
    with and without jitter), K surfaces at the path's rays
    (kernel_bench.K8_RAYS): the masks equal, the depths by
    kernel_bench.k8_check's tolerance."""
    from volsurfs_tpu_torch import kernel_bench as kb
    from volsurfs_tpu_torch.ops import volume_rendering as VR

    for samples, sdfs, beta, n, jitter in kb.k8_cases(cuda, K)["importance"].values():
        for jit in (jitter, None):
            got = VR.neus_importance(samples, sdfs, beta, n, jit)
            ref = VR.neus_importance_reference(samples, sdfs, beta, n, jit)
            _check_k8("importance", (got.z, got.mask), (ref.z, ref.mask))


def _importance_edge_case(device, S, K, R=256, seed=0):
    """(samples, sdfs [R, S, K], beta): R rays of S samples with prefix
    masks, the first rays of 0, 1, 2 and S valid samples, the rest of
    random counts; the SDFs cross 0 along the rays, each surface a shifted
    copy of the main one (kernel_bench.k8_cases' SDFs)."""
    from volsurfs_tpu_torch import kernel_bench as kb

    rng = np.random.default_rng(seed + 10 * S + K)
    count = rng.integers(0, S + 1, (R, 1))
    count[:8] = [[0], [1], [min(2, S)], [S], [0], [1], [min(2, S)], [S]]
    samples = kb.k8_samples(device, rng, R, S, count)
    noise = torch.from_numpy(rng.standard_normal((R, S)).astype(np.float32)).to(device)
    base = 2.0 - samples.z + 0.02 * noise
    offsets = torch.tensor(kb.K8_OFFSETS[5 - K:], device=device)
    return samples, (base[..., None] + offsets).contiguous(), 18.5


@pytest.mark.parametrize("K", [1, 3, 5])
@pytest.mark.parametrize("S", [2, 33, 80, 300])
def test_importance_kernel_edge_rays(cuda, S, K):
    """K8c at row lengths on either side of the warp layout's chunks and
    tiles, K surfaces, 16 and 48 new depths (more targets than lanes), with
    and without jitter, on rays of 0, 1, 2 and S valid samples: the masks
    equal, the depths by kernel_bench.k8_check's tolerance."""
    from volsurfs_tpu_torch.ops import volume_rendering as VR

    samples, sdfs, beta = _importance_edge_case(cuda, S, K)
    rng = np.random.default_rng(S)
    for n in (16, 48):
        jitter = torch.from_numpy(
            rng.uniform(-0.5, 0.5, (samples.z.shape[0], n)).astype(np.float32)).to(cuda)
        for jit in (jitter, None):
            got = VR.neus_importance(samples, sdfs, beta, n, jit)
            ref = VR.neus_importance_reference(samples, sdfs, beta, n, jit)
            _check_k8("importance", (got.z, got.mask), (ref.z, ref.mask))


@pytest.mark.parametrize("K", [1, 10])
def test_importance_kernel_long_rays(cuda, K):
    """K8c at the wrapper's longest rows, 4,096 samples: at K = 1 a ray's
    staged row takes more than the static 48 KB of shared memory (the
    kernel's limit is raised), at K = 10 more than a block may take (its
    SDFs are then read in place): the masks equal, the depths by
    kernel_bench.k8_check's tolerance."""
    from volsurfs_tpu_torch.ops import volume_rendering as VR

    samples, sdfs, beta = _importance_edge_case(cuda, 4096, 1, R=32)
    sdfs = (sdfs + torch.linspace(0.1, 0.0, K, device=cuda)).contiguous()
    got = VR.neus_importance(samples, sdfs, beta, 16)
    ref = VR.neus_importance_reference(samples, sdfs, beta, 16)
    _check_k8("importance", (got.z, got.mask), (ref.z, ref.mask))


# ---- K8d: the nerf importance round --------------------------------------


@pytest.mark.parametrize("R", [512, 2048])
def test_nerf_importance_kernel_matches_plain(cuda, R):
    """K8d at the nerf step's shape (64 samples, 32 new depths, the path's
    512 rays) and a 2,048-ray render chunk's, with and without jitter
    (kernel_bench.k8d_case): the masks equal, the depths by
    kernel_bench.k8_check's tolerance, as K8c's."""
    from volsurfs_tpu_torch import kernel_bench as kb
    from volsurfs_tpu_torch.ops import volume_rendering as VR

    samples, density, n, jitter = kb.k8d_case(cuda, R)
    for jit in (jitter, None):
        got = VR.nerf_importance(samples, density, n, jit)
        ref = VR.nerf_importance_reference(samples, density, n, jit)
        _check_k8("importance", (got.z, got.mask), (ref.z, ref.mask))


@pytest.mark.parametrize("S", [2, 33, 64, 97, 300])
def test_nerf_importance_kernel_edge_rays(cuda, S):
    """K8d at row lengths on either side of the warp layout's chunks and
    tiles, 32 and 48 new depths (more targets than lanes), with and without
    jitter, on rays of 0, 1, 2 and S valid samples, rays of zero density
    (their weights' sum under the 1e-6 floor) and of a density of 1e30
    (alpha 1 at once): the masks equal, the depths by k8_check's
    tolerance."""
    from volsurfs_tpu_torch import kernel_bench as kb
    from volsurfs_tpu_torch.ops import volume_rendering as VR

    R = 256
    count = np.random.default_rng(S).integers(0, S + 1, (R, 1))
    count[:8] = [[0], [1], [min(2, S)], [S], [S], [S], [S], [S]]
    for n in (32, 48):
        samples, density, _, jitter = kb.k8d_case(cuda, R, S, n, seed=S + n, count=count)
        density[4:6] = 0.0
        density[6:8] = 1e30
        for jit in (jitter, None):
            got = VR.nerf_importance(samples, density, n, jit)
            ref = VR.nerf_importance_reference(samples, density, n, jit)
            _check_k8("importance", (got.z, got.mask), (ref.z, ref.mask))


def test_nerf_steps_on_the_card(cuda, tmp_path):
    """The nerf configuration of tests/_stage_config.py for 60 steps (two
    occupancy refreshes) through Trainer.train, then a render of a test
    camera: finite losses and frame, and the path launched K6 (forward and
    backward), K7, K8a, K8b (forward and backward) and K8d, no plain
    version, not K1 and not K8c."""
    from volsurfs_tpu_torch.methods.nerf import NeRF
    from volsurfs_tpu_torch.ops import permuto as P
    from volsurfs_tpu_torch.ops import samplers as SP
    from volsurfs_tpu_torch.ops import samples as TS
    from volsurfs_tpu_torch.ops import volume_rendering as VR
    from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
    from volsurfs_tpu_torch.params.hyper_params import HyperParamsNeRF
    from volsurfs_tpu_torch.training.trainer import Trainer

    from _stage_config import NERF_DATA, NERF_HP, NERF_OCCUPANCY_RES

    modules = (S.launches, P.launches, SP.launches, TS.launches, VR.launches)
    for counts in modules:
        for key in counts:
            counts[key] = 0
    mv = MVDataset("synthetic", "sphere", "", config=NERF_DATA)
    method = NeRF(HyperParamsNeRF(**NERF_HP), make_bounding_sphere(1.0), bg_color="white",
                  occupancy_res=NERF_OCCUPANCY_RES, device=cuda)
    trainer = Trainer(method, mv, str(tmp_path))
    losses = []
    trainer.train(end_iter=60, callback=lambda it, m, l: losses.append(float(l["loss"])))
    assert len(losses) == 60 and np.isfinite(losses).all()
    out = trainer.render_camera(mv["test"].cameras[0])
    assert out["rgb"].shape == (32, 32, 3) and np.isfinite(out["rgb"]).all()
    counts = {k: v for c in modules for k, v in c.items()}
    assert min(counts[k] for k in ("permuto_fwd", "permuto_bwd", "occupancy_sampler",
                                   "combine_samples", "neus_transmittance_fwd",
                                   "neus_transmittance_bwd", "nerf_importance")) > 0, counts
    assert counts["scatter_add"] == 0 and counts["neus_importance"] == 0, counts
    assert not any(v for k, v in counts.items() if k.endswith("_reference")), counts


def test_offsets_surfs_steps_on_the_card(cuda, tmp_path):
    """tests/test_offsets_surfs_e2e.py's configuration (permutohash, 3
    surfaces) for its 36 steps through Trainer.train, every phase, then a
    render of a test camera: finite losses and frame, every surface's
    opacity, and the path launched K6, K7 and K8's kernels, no plain
    version."""
    from volsurfs_tpu_torch.methods.offsets_surfs import OffsetsSurfs
    from volsurfs_tpu_torch.ops import permuto as P
    from volsurfs_tpu_torch.ops import samplers as SP
    from volsurfs_tpu_torch.ops import samples as TS
    from volsurfs_tpu_torch.ops import volume_rendering as VR
    from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
    from volsurfs_tpu_torch.params.hyper_params import HyperParamsOffsetsSuRFs
    from volsurfs_tpu_torch.training.trainer import Trainer

    modules = (P.launches, SP.launches, TS.launches, VR.launches)
    for counts in modules:
        for key in counts:
            counts[key] = 0
    hp = HyperParamsOffsetsSuRFs(
        is_nr_training_rays_dynamic=False, training_rays_batch_size=48,
        max_nr_samples_per_ray=12, max_nr_imp_samples_per_ray=8, do_importance_sampling=True,
        init_phase_end_iter=8, color_init_phase_end_iter=16, first_phase_end_iter=30,
        training_end_iter=36, nr_warmup_iters=4, lr=3e-3, lr_milestones=[10000],
        nr_inner_surfs=1, nr_outer_surfs=1, eikonal_weight=0.04,
        support_surfs_eikonal_weight=0.04, offsurface_weight=1e-4, curvature_weight=0.0,
        geom_feat_size=16, sdf_nr_iters_for_c2f=0)
    mv = MVDataset("synthetic", "sphere", "",
                   config={"width": 24, "height": 24, "nr_train_cameras": 4,
                           "nr_test_cameras": 1})
    method = OffsetsSurfs(hp, make_bounding_sphere(1.0), bg_color="white", occupancy_res=16,
                          device=cuda)
    trainer = Trainer(method, mv, str(tmp_path))
    losses = []
    trainer.train(callback=lambda it, m, l: losses.append(float(l["loss"])))
    assert len(losses) == 36 and np.isfinite(losses).all() and losses[7] < losses[0]
    out = trainer.render_camera(mv["test"].cameras[0])
    assert out["rgb"].shape == (24, 24, 3) and np.isfinite(out["rgb"]).all()
    assert out["surfs_alpha"].shape == (24, 24, 3)
    counts = {k: v for c in modules for k, v in c.items()}
    assert min(counts[k] for k in ("permuto_fwd", "permuto_bwd", "occupancy_sampler",
                                   "combine_samples", "neus_transmittance_fwd",
                                   "neus_transmittance_bwd", "neus_importance")) > 0, counts
    assert not any(v for k, v in counts.items() if k.endswith("_reference")), counts


@pytest.mark.parametrize("kind", ["sphere", "random"])
def test_device_marching_matches_host_marching(cuda, kind):
    """marching_tetrahedra on the card against the same values marched on
    the host: faces equal, vertices within 1e-6 (at 96^3)."""
    from volsurfs_tpu_torch.baking.marching import marching_tetrahedra

    n = 96
    rng = np.random.default_rng(0)
    lin = np.linspace(-1.0, 1.0, n)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    values = (np.sqrt(x**2 + y**2 + z**2) - 0.6 if kind == "sphere"
              else rng.standard_normal((n, n, n))).astype(np.float32)
    origin, spacing = np.full(3, -1.0), np.full(3, 2.0 / (n - 1))
    dv, df = marching_tetrahedra(torch.from_numpy(values).to(cuda), origin, spacing)
    hv, hf = marching_tetrahedra(torch.from_numpy(values), origin, spacing)
    assert len(hf) > 1000
    np.testing.assert_array_equal(df, hf)
    np.testing.assert_allclose(dv, hv, rtol=0, atol=1e-6)


def test_pipeline_on_the_card(cuda, tmp_path, monkeypatch):
    """run_pipeline at tests/_pipeline_config.py's sizes on the card: every
    stage trains, at least two shells and a scene.json, and the path
    launched K6 (the extraction), K1, K2 and K4, no plain version."""
    from volsurfs_tpu_torch.methods.offsets_surfs import OffsetsSurfs
    from volsurfs_tpu_torch.methods.surf import Surf
    from volsurfs_tpu_torch.ops import permuto as P
    from volsurfs_tpu_torch.pipeline import run_pipeline

    from _pipeline_config import DATA, INIT_POINTS, PIPELINE_KWARGS, STEPS, hps

    monkeypatch.setattr(Surf, "nr_sphere_init_points", INIT_POINTS)
    monkeypatch.setattr(OffsetsSurfs, "nr_offsets_init_points", INIT_POINTS)
    modules = (P.launches, S.launches, TB.launches, SH.launches)
    for counts in modules:
        for key in counts:
            counts[key] = 0
    mv = MVDataset("synthetic", "sphere", "", config=DATA)
    results = run_pipeline(mv, str(tmp_path), *hps(), device=cuda, **PIPELINE_KWARGS)
    assert results["steps"] == STEPS and len(results["meshes"]) >= 2
    assert os.path.exists(results["scene_json"])
    renderer = BakedMeshRenderer(results["volsurfs_dir"], device=cuda)
    img = renderer.render(mv["test"].cameras[0])
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    counts = {k: v for c in modules for k, v in c.items()}
    for name in ("permuto_fwd", "scatter_add", "bvh_trace", "shade"):
        assert counts[name] > 0 and counts[name + "_reference"] == 0, counts


# ---- K10 and K9: the background's samples and the sphere-trace step --------


@pytest.mark.parametrize("R,N,jitter", [(512, 64, True), (65536, 64, True), (2048, 64, False),
                                        (512, 32, True), (511, 2, True), (513, 33, True),
                                        (512, 48, True), (1000, 96, False)])
def test_bg_samples_kernel_matches_plain_bit_for_bit(cuda, R, N, jitter):
    """K10 at the paths' shapes (surf's step, a sphere-traced frame, an eval
    chunk, volsurfs' step) and at rows that are not a warp (2 samples, two
    rows a block and the last block half full; 33 and 48, a row's points
    off a 16-byte boundary; 96, three warps a row), a quarter of the rays
    starting at 0: the contracted points and directions, distances, gaps,
    max_dt and depths equal the plain version's bit for bit."""
    from volsurfs_tpu_torch import kernel_bench as kb
    from volsurfs_tpu_torch.ops import samplers as SP

    args = kb.k10_case(cuda, R, N, jitter)
    got = SP.contracted_bg_samples(*args)
    ref = SP.bg_samples_reference(*args)
    torch.cuda.synchronize()
    result = kb.k10_check(got, ref)
    assert result["ok"], result
    assert float(got[0].norm(dim=-1).max()) <= 1.0


def test_bg_samples_kernel_rejects_wrong_inputs(cuda):
    from volsurfs_tpu_torch.ops import samplers as SP

    o = torch.zeros(4, 3, device=cuda)
    with pytest.raises(ValueError, match="t_start"):
        SP.contracted_bg_samples(o, o, torch.zeros(4, 2, device=cuda), 8)
    with pytest.raises(ValueError, match="at least 2"):
        SP.contracted_bg_samples(o, o, torch.zeros(4, 1, device=cuda), 1)
    with pytest.raises(ValueError, match="at most 1024"):
        SP.contracted_bg_samples(o, o, torch.zeros(4, 1, device=cuda), 1025)


@pytest.mark.parametrize("grid", [False, True])
def test_sphere_trace_step_kernel_matches_plain_analytic(cuda, grid):
    """A 24-step compacted march of a 256^2 frame at an analytic sphere,
    without and with a 256^3 grid (the coarse 4^3 level on): after every
    step the state of every ray equals the compacted plain march's bit for
    bit, and the lists hold the same rays and probe points, each step given
    the same SDF by ray."""
    from volsurfs_tpu_torch import kernel_bench as kb

    rays_o, rays_d, sdf, space, state = kb.k9_case(cuda, grid=grid, pre_steps=0)
    result = kb.k9_march_check(rays_o, rays_d, sdf, space, state, steps=24)
    assert result["ok"], result


@pytest.mark.parametrize("res", [0, 24, 22])
def test_sphere_trace_step_kernel_matches_plain_surf_field(cuda, res):
    """A 24-step compacted march of a small random surf SDF (the full
    24-level table, an MLP 16-16) from a camera, without a grid and with its
    refreshed grid at 24^3 (the coarse level on) and 22^3 (off), against
    the compacted plain march: bit for bit, each step given the same SDF by
    ray."""
    from volsurfs_tpu_torch import kernel_bench as kb
    from volsurfs_tpu_torch.methods.surf import Surf
    from volsurfs_tpu_torch.ops import sphere_tracing as ST
    from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
    from volsurfs_tpu_torch.params.hyper_params import HyperParamsSuRF

    hp = HyperParamsSuRF(appearance_predict_sh_coeffs=True, sdf_mlp_layers_dims=[16, 16],
                         geom_feat_size=8, rgb_mlp_layers_dims=[32, 32], sh_degree=2,
                         init_phase_end_iter=10, first_phase_end_iter=100,
                         use_occupancy_grid=res > 0)
    method = Surf(hp, make_bounding_sphere(1.0), bg_color="white", occupancy_res=res or 8,
                  device=cuda, seed=3)
    rng = np.random.default_rng(res)
    table = method.models["sdf"].encoder.table
    with torch.no_grad():
        table.copy_(torch.from_numpy(rng.uniform(-0.05, 0.05, tuple(table.shape))
                                     .astype(np.float32)).to(cuda))
    method.iter_nr = 30
    method.update_occupancy_grid()
    o = np.tile(np.float32([[0.0, 0.0, -2.0]]), (4096, 1))
    d = rng.normal(0, 0.3, (4096, 3)).astype(np.float32) + np.float32([0, 0, 1])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays_o, rays_d = torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)
    space = ST.trace_space(method.bounding_primitive, 1e-3, 8e-3, method.grid)
    state = ST.trace_start(rays_o, rays_d, space)

    def sdf(p):
        with torch.no_grad():
            return method._sdf(p, method.iter_nr)[0]

    result = kb.k9_march_check(rays_o, rays_d, sdf, space, state, steps=24)
    assert result["ok"], result


@pytest.mark.parametrize("grid", [False, True])
def test_compacted_traces_of_one_frame_agree(cuda, grid):
    """Two compacted traces of one 256^2 frame at an analytic sphere
    (without and with a 256^3 grid), whose lists come in the atomics'
    order: the same t and flags and steps, bit for bit, and the same as
    JAX's lockstep loop with the plain step (the SDF point by point)."""
    from volsurfs_tpu_torch import kernel_bench as kb
    from volsurfs_tpu_torch.ops import sphere_tracing as ST

    rays_o, rays_d, sdf, space, _ = kb.k9_case(cuda, grid=grid, pre_steps=0)
    field = lambda p: sdf(p)[:, 0]  # noqa: E731
    ST.launches["sphere_trace_step"] = 0
    (a, n_a), (b, n_b) = (ST.march(field, rays_o, rays_d, space, 24) for _ in range(2))
    assert ST.launches["sphere_trace_step"] == n_a + n_b
    ref, n_ref = ST.march_lockstep_reference(field, rays_o, rays_d, space, 24)
    assert n_a == n_b == n_ref
    for k in (0, 5, 6, 7):
        assert torch.equal(a[k], b[k]) and torch.equal(a[k], ref[k]), k
    assert 0.05 < float((a[6] | a[5]).float().mean()) < 0.95


@pytest.mark.parametrize("with_grad", [False, True])
def test_permuto_forward_kernel_on_contracted_points(cuda, with_grad):
    """K6 forward at the background's points: contracted into the unit
    ball, every coordinate of either sign, with bb_sides None (the points
    as they are): feats and dfeats bit for bit."""
    from volsurfs_tpu_torch.models.encodings import PermutoEncoder
    from volsurfs_tpu_torch.ops import samplers as SP

    rng = np.random.default_rng(9)
    enc = PermutoEncoder(bb_sides=None).to(cuda)
    with torch.no_grad():
        enc.table.copy_(torch.from_numpy(
            rng.uniform(-0.5, 0.5, tuple(enc.table.shape)).astype(np.float32)))
    pts = torch.from_numpy(rng.uniform(-20, 20, (65536, 3)).astype(np.float32)).to(cuda)
    unit = SP.contract_points(pts).contiguous()
    assert float(unit.min()) < -0.9 and float(unit.max()) > 0.9
    _check_permuto_forward(enc, unit, with_grad)


def test_surf_with_the_trained_background_on_the_card(cuda, tmp_path):
    """The surf configuration of tests/_stage_config.py with the trained
    background for 64 steps through Trainer.train, a volumetric and a
    sphere-traced render of a test camera: finite losses and frames, and
    the path launched K6, K7, K8b, K9 and K10, no plain version."""
    from volsurfs_tpu_torch.datasets.cameras import get_camera_rays
    from volsurfs_tpu_torch.methods.surf import Surf
    from volsurfs_tpu_torch.ops import permuto as P
    from volsurfs_tpu_torch.ops import samplers as SP
    from volsurfs_tpu_torch.ops import samples as TS
    from volsurfs_tpu_torch.ops import sphere_tracing as ST
    from volsurfs_tpu_torch.ops import volume_rendering as VR
    from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
    from volsurfs_tpu_torch.params.hyper_params import HyperParamsSuRF
    from volsurfs_tpu_torch.training.trainer import Trainer

    from _stage_config import SURF_DATA, SURF_HP, SURF_INIT_SPHERE_RADIUS, SURF_OCCUPANCY_RES

    modules = (P.launches, SP.launches, TS.launches, VR.launches, ST.launches)
    for counts in modules:
        for key in counts:
            counts[key] = 0
    mv = MVDataset("synthetic", "sphere", "", config=SURF_DATA)
    method = Surf(HyperParamsSuRF(**SURF_HP), make_bounding_sphere(1.0), bg_color="trained",
                  init_sphere_radius=SURF_INIT_SPHERE_RADIUS, occupancy_res=SURF_OCCUPANCY_RES,
                  device=cuda)
    trainer = Trainer(method, mv, str(tmp_path))
    losses = []
    trainer.train(end_iter=64, callback=lambda it, m, l: losses.append(float(l["loss"])))
    assert np.isfinite(losses).all()
    out = trainer.render_camera(mv["test"].cameras[0])
    assert np.isfinite(out["rgb"]).all()
    rays_o, rays_d = (torch.from_numpy(x).to(cuda) for x in get_camera_rays(mv["test"].cameras[0]))
    traced = method.make_render_fn(sphere_traced=True)(rays_o, rays_d)
    assert bool(torch.isfinite(traced["rgb"]).all()) and method.last_trace_steps > 0
    counts = {k: v for c in modules for k, v in c.items()}
    assert min(counts[k] for k in ("permuto_fwd", "permuto_bwd", "occupancy_sampler",
                                   "neus_transmittance_fwd", "neus_transmittance_bwd",
                                   "bg_samples", "sphere_trace_step")) > 0, counts
    assert not any(v for k, v in counts.items() if k.endswith("_reference")), counts
