"""Shading of baked shells: band-texture fetch, SH evaluation, sigmoid and
float16 outer->inner compositing, for every ray over its k shell hits.

Counterpart of volsurfs_tpu/renderers/mesh_renderer.py's
``_sample_bands_mesh``, ``_shade_mesh`` and ``_composite`` (:271-375). The
entry ``shade_composite_buffers`` takes the hits as the trace kernel K2
writes them (``ops/bvh.trace_all_buffers``). On a CUDA tensor it launches
kernel K4 (``csrc/shade.cu``, one thread a ray, a 16x8 pixel tile a block
on a frame); on a CPU tensor it runs the plain version
``_shade_composite_reference`` (on ``trace_all``'s dict of the same hits),
torch ops in the JAX op order.

Textures (``BandTextures``): every (mesh, band) texture as uint8 texels
[H, W, 4*C] (C = the band's SH coefficients; byte ``ch*C + j`` is colour
channel ch of coefficient j, the JAX [H, W, 4, C] order), all in one flat
buffer, with a table of each one's offset, H, W, 4*C, ``lo`` and
``(hi - lo)/255`` (both rounded to float16). The JAX package packs texel
blocks into gather rows (``make_band_table``), a workaround for the TPU's
gather width; the texels and bilinear weights it reads are those of the
clamped 2x2 footprint read here directly.

Rounding, as the JAX code run op by op: a texel weight is a float16
product of float16 (1 - f) or f; each of the four texel products is
rounded to float16 and the four are summed in float32 and rounded once (a
float16 dot with float32 accumulation); ``lo + scale*s`` in float16; the SH
contraction of float16 values in float32, rounded once; a float32 sigmoid
cast to float16; the compositing in float16 with a float32 sum over shells
(``jnp.sum`` upcasts float16).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from volsurfs_tpu_torch import _build
from volsurfs_tpu_torch.ops.sh import sh_eval
from volsurfs_tpu_torch.utils.math import small_cumprod, take_rev

DEG_NR_COEFFS = (1, 3, 5, 7)  # SH coefficients of each band (degree)
MAX_SHELLS = 9  # K4 keeps every shell's hit in registers (base_9.cfg has 9)

# launch counts: the CUDA kernel's and the plain version's
launches = {"shade": 0, "shade_reference": 0}


@dataclasses.dataclass
class BandTextures:
    """The scene's band textures in one flat uint8 buffer.

    texels [bytes] uint8 on the device; table [k*nb, 4] int64 (offset, H,
    W, 4*C) and scales [k*nb, 2] float32 (lo, (hi-lo)/255, float16-exact)
    of band b of mesh m at row m*nb + b, numpy on the host; kernel_table
    [k*nb, 8] int32 on the device, the same as K4 reads it (offset in
    32-bit words, H, W, lo and scale as float16 bits in both halves of a
    word, 3 zeros)."""

    texels: torch.Tensor
    table: np.ndarray
    scales: np.ndarray
    kernel_table: torch.Tensor
    nr_meshes: int
    nr_bands: int

    def band(self, m: int, b: int):
        """The texels of band b of mesh m as [H*W, 4*C] and (lo, scale) as
        float16 0-d tensors."""
        off, H, W, C = (int(x) for x in self.table[m * self.nr_bands + b])
        lo, scale = (float(x) for x in self.scales[m * self.nr_bands + b])
        tex = self.texels[off:off + H * W * C].view(H * W, C)
        half = dict(dtype=torch.float16, device=self.texels.device)
        return tex, H, W, C, torch.tensor(lo, **half), torch.tensor(scale, **half)


def make_band_textures(textures_u8, tex_scales, device) -> BandTextures:
    """textures_u8[m][b]: uint8 [H, W, 4, C] numpy; tex_scales[m][b]:
    (lo, hi)."""
    k, nb = len(textures_u8), len(textures_u8[0])
    chunks, table, scales, off = [], [], [], 0
    for m in range(k):
        if len(textures_u8[m]) != nb:
            raise ValueError("every mesh needs the same number of bands")
        for b in range(nb):
            tex = np.ascontiguousarray(textures_u8[m][b], np.uint8)
            H, W = tex.shape[:2]
            C = tex.shape[2] * tex.shape[3]
            chunks.append(tex.reshape(-1))
            table.append((off, H, W, C))
            lo, hi = tex_scales[m][b]
            # rounded as JAX rounds jnp.asarray(python float, float16)
            scales.append((np.float16(lo), np.float16((hi - lo) / 255.0)))
            off += tex.size  # 4*C bytes a texel: every offset is a multiple of 4
    if off // 4 >= 2**31:
        raise ValueError(f"band textures of {off} bytes: K4 addresses at most 2^31 words")
    table = np.asarray(table, np.int64)
    scales = np.asarray(scales, np.float16)
    bits = scales.view(np.uint16).astype(np.int64) * 0x10001  # both halves of a word
    kernel_table = np.zeros((k * nb, 8), np.int64)
    kernel_table[:, 0] = table[:, 0] // 4
    kernel_table[:, 1:3] = table[:, 1:3]
    kernel_table[:, 3:5] = bits
    return BandTextures(
        texels=torch.from_numpy(np.concatenate(chunks)).to(device),
        table=table, scales=scales.astype(np.float32),
        kernel_table=torch.from_numpy(kernel_table.astype(np.uint32).view(np.int32)).to(device),
        nr_meshes=k, nr_bands=nb,
    )


def face_uv_table(meshes, device):
    """(uv rows [sum F, 6] float32: the three vertex UVs of each face, mesh
    after mesh; face offsets [k] int64). meshes: (faces [F, 3], uvs [V, 2])
    numpy pairs."""
    rows, offsets, off = [], [], 0
    for faces, uvs in meshes:
        faces = np.asarray(faces, np.int64)
        uvs = np.asarray(uvs, np.float32)
        rows.append(np.concatenate([uvs[faces[:, 0]], uvs[faces[:, 1]], uvs[faces[:, 2]]], -1))
        offsets.append(off)
        off += faces.shape[0]
    return (torch.from_numpy(np.concatenate(rows)).to(device),
            torch.tensor(offsets, dtype=torch.int64, device=device))


def interp_uv(face_uv, face_offset: int, triangles_id, barycentric):
    """(1-u-v) a + u b + v c of a hit face's vertex UVs, as TensorMesh.face_attr
    computes it: uv [N, 2]."""
    uv6 = face_uv[face_offset + torch.clamp(triangles_id, min=0)]
    u = barycentric[..., 0:1]
    v = barycentric[..., 1:2]
    return (1.0 - u - v) * uv6[:, 0:2] + u * uv6[:, 2:4] + v * uv6[:, 4:6]


def _corners(x, size: int):
    """Bilinear corners of texel coordinate x along one axis: (first index,
    second index, weight of the second as float16). Below texel 0 both
    corners are texel 0 and all weight is on the first; past the last texel
    both are the last."""
    x0 = torch.floor(x)
    f = torch.where(x0 < 0, 0.0, x - x0).to(torch.float16)
    i0 = torch.clamp(x0, 0, size - 1).long()
    return i0, torch.clamp(i0 + 1, max=size - 1), f


def sample_bands(tex: BandTextures, m: int, u, v, work=None):
    """Bilinear SH coefficients of mesh m at texture coordinates u, v [N]
    (float32): [N, 4, sum of the bands' C] float16."""
    N = u.shape[0]
    bands = []
    for b in range(tex.nr_bands):
        texels, H, W, C, lo, scale = tex.band(m, b)
        x0, x1, fx = _corners(u * W - 0.5, W)
        y0, y1, fy = _corners((1.0 - v) * H - 0.5, H)
        wx0, wy0 = 1.0 - fx, 1.0 - fy
        s = None
        # footprint order (y0, x0), (y0, x1), (y1, x0), (y1, x1), summed in float32
        for yi, xi, w in ((y0, x0, wy0 * wx0), (y0, x1, wy0 * fx),
                          (y1, x0, fy * wx0), (y1, x1, fy * fx)):
            rows = yi * W + xi
            if work is not None:
                work["texels"][(m, b)].append(rows)
            p = (texels[rows].to(torch.float16) * w[:, None]).float()
            s = p if s is None else s + p
        sampled = lo + scale * s.to(torch.float16)
        bands.append(sampled.reshape(N, 4, C // 4))
    return torch.cat(bands, dim=-1)


def shade_mesh(tex: BandTextures, m: int, uv, hit, dirs, sh_degree: int, ignore_alpha: bool,
               work=None):
    """Texture lookup, SH evaluation and sigmoid for mesh m: uv [N, 2], hit
    [N], dirs [N, 3] -> (rgb [N, 3], alpha [N, 1]) float16, zero off-hit."""
    coeffs = sample_bands(tex, m, uv[:, 0], uv[:, 1], work)
    vals = torch.sigmoid(sh_eval(coeffs, dirs.to(torch.float16), sh_degree).float())
    rgb = vals[:, :3]
    alpha = torch.ones_like(vals[:, 3:4]) if ignore_alpha else vals[:, 3:4]
    is_hit = hit[:, None]
    return (torch.where(is_hit, rgb, 0.0).to(torch.float16),
            torch.where(is_hit, alpha, 0.0).to(torch.float16))


def composite(surfs_rgb, surfs_alpha, bg_color):
    """float16 outer->inner compositing: surfs_rgb [N, k, 3], surfs_alpha
    [N, k, 1] float16 in scene order (innermost first); bg_color [3]
    float32. Returns {"rgb" [N, 3], "bg_transmittance" [N, 1]} float32."""
    rgb_o2i = take_rev(surfs_rgb, dim=1)
    alpha_o2i = take_rev(surfs_alpha, dim=1)
    T = small_cumprod(1.0 - alpha_o2i, dim=1)
    surfs_T = torch.cat([torch.ones_like(T[:, :1]), T[:, :-1]], dim=1)
    bg_T = T[:, -1]
    rgb_fg = torch.sum((rgb_o2i * surfs_T * alpha_o2i).float(), dim=1).to(torch.float16)
    rgb = rgb_fg.float() + bg_T.float() * bg_color
    return {"rgb": rgb, "bg_transmittance": bg_T.float()}


def _shade_composite_reference(hits, face_uv, face_offsets, rays_d, tex: BandTextures,
                               ignore_alpha, bg_color, sh_degree: int, return_work=False):
    """Plain version of ``shade_composite_buffers``, torch ops in the JAX op
    order, on ``trace_all``'s dict of the hits (is_hit [k, N] bool,
    triangles_id [k, N] int64, barycentric [k, N, 2] float32).

    With return_work, returns (out, work): work counts the (shell, ray)
    hits, the rays with a hit on any shell (``rays_hit``: the others take
    the background alone and need no direction), the distinct faces they
    hit (``faces_hit``), the distinct texel
    bytes they read and the kernel's float32 operations for them (see
    ``shade_flops``), what a shade of these rays needs."""
    launches["shade_reference"] += 1
    k = hits["is_hit"].shape[0]
    work = None
    if return_work:
        work = {"texels": {(m, b): [] for m in range(k) for b in range(tex.nr_bands)}}
    offsets = [int(o) for o in face_offsets.tolist()]
    rgbs, alphas = [], []
    for m in range(k):
        uv = interp_uv(face_uv, offsets[m], hits["triangles_id"][m], hits["barycentric"][m])
        rgb, alpha = shade_mesh(tex, m, uv, hits["is_hit"][m], rays_d, sh_degree,
                                bool(ignore_alpha[m]), work)
        rgbs.append(rgb)
        alphas.append(alpha)
    out = composite(torch.stack(rgbs, 1), torch.stack(alphas, 1), bg_color)
    if not return_work:
        return out
    n_bytes, n_hits = 0, int(hits["is_hit"].sum())
    band_bytes = tex.table[:, 3].reshape(k, tex.nr_bands).tolist()  # 4*C of each (mesh, band)
    for (m, b), rows in work["texels"].items():
        hit = hits["is_hit"][m]
        n_bytes += int(torch.unique(torch.cat([r[hit] for r in rows])).numel()) * band_bytes[m][b]
    faces_hit = sum(int(torch.unique(hits["triangles_id"][m][hits["is_hit"][m]]).numel())
                    for m in range(k))
    hit_per_mesh = [int(h) for h in hits["is_hit"].sum(dim=1).tolist()]
    flops = shade_flops(hit_per_mesh, band_bytes, rays_d.shape[0])
    rays_hit = int(hits["is_hit"].any(dim=0).sum())
    return out, {"hits": n_hits, "rays_hit": rays_hit, "faces_hit": faces_hit,
                 "texel_bytes": n_bytes, "flops": flops}


def shade_flops(hits_per_mesh, band_bytes, nr_rays):
    """float32 operations of K4 for these hits (each float16 operation
    counted as one; band_bytes[m][b] is 4*C of band b of mesh m): per ray,
    the SH basis (~60) and the compositing of k shells (8 a shell) and the
    background (2 a channel); per hit, the uv interpolation (10), the
    sigmoid (4 x 3) and per band the corners and weights (20) and per
    texel byte 4 products, 3 sums, lo + scale (2) and the SH product and
    sum (2)."""
    per_ray = 60 + 8 * len(hits_per_mesh) + 6
    total = per_ray * nr_rays
    for n, sizes in zip(hits_per_mesh, band_bytes):
        per_hit = 10 + 12 + sum(20 + 11 * C for C in sizes)
        total += n * per_hit
    return total


def hits_from_buffers(tri, u, v, k: int):
    """``trace_all``'s is_hit, triangles_id and barycentric [k, N, ...] of
    K2's buffers (``trace_all_buffers``: tri int32, u, v float32 [k*N])."""
    tri = tri.reshape(k, -1)
    return {"is_hit": tri >= 0, "triangles_id": tri.long(),
            "barycentric": torch.stack([u, v], dim=-1).reshape(k, -1, 2)}


def shade_composite_buffers(tri, u, v, face_uv, face_offsets, rays_d, tex: BandTextures,
                            ignore_alpha, bg_color, sh_degree: int, width: int = 0):
    """Shade every ray over its k shell hits and composite them outer->inner.

    tri int32, u, v float32, each [k*N]: K2's buffers
    (``ops/bvh.trace_all_buffers``), mesh m's rays at [m*N, (m+1)*N), a hit
    where tri >= 0; face_uv [sum F, 6] float32 and face_offsets [k] int64
    (``face_uv_table``); rays_d [N, 3] float32; ignore_alpha [k] bool
    tensor; bg_color [3] float32. width: 0 for any rays; W > 0 for the rays
    of a row-major frame W pixels wide (N a multiple of W), which K4 shades
    in 16x8 pixel tiles. The result is the same either way. Returns {"rgb"
    [N, 3], "bg_transmittance" [N, 1]} float32, as JAX's ``_composite``
    returns them."""
    if not rays_d.is_cuda:
        return _shade_composite_reference(hits_from_buffers(tri, u, v, tex.nr_meshes), face_uv,
                                          face_offsets, rays_d, tex, ignore_alpha, bg_color,
                                          sh_degree)
    return _launch(tri, u, v, face_uv, face_offsets, rays_d, tex, ignore_alpha, bg_color,
                   sh_degree, width)


def _launch(tri, u, v, face_uv, face_offsets, rays_d, tex, ignore_alpha, bg_color, sh_degree,
            width):
    """K4 on CUDA tensors; checks every argument first."""
    k, N = tex.nr_meshes, rays_d.shape[0]
    dev = rays_d.device
    for name, x, dtype in (
        ("tri", tri, torch.int32), ("u", u, torch.float32), ("v", v, torch.float32),
        ("face_uv", face_uv, torch.float32), ("face_offsets", face_offsets, torch.int64),
        ("rays_d", rays_d, torch.float32), ("texels", tex.texels, torch.uint8),
        ("kernel_table", tex.kernel_table, torch.int32),
        ("ignore_alpha", ignore_alpha, torch.bool), ("bg_color", bg_color, torch.float32),
    ):
        if x.device != dev or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(
                f"shade_composite_buffers: {name} must be a contiguous {dtype} tensor on {dev}, "
                f"got {x.dtype} on {x.device}")
    if (tri.shape != (k * N,) or u.shape != (k * N,) or v.shape != (k * N,)
            or rays_d.shape != (N, 3) or face_uv.ndim != 2 or face_uv.shape[1] != 6
            or face_offsets.shape != (k,) or ignore_alpha.shape != (k,)
            or bg_color.shape != (3,) or tex.nr_bands != sh_degree + 1
            or tex.kernel_table.shape != (k * tex.nr_bands, 8)):
        raise ValueError(
            f"shade_composite_buffers: bad shapes: hits {tuple(tri.shape)}, rays_d "
            f"{tuple(rays_d.shape)}, face_uv {tuple(face_uv.shape)}, {k} x "
            f"{tex.nr_bands} bands for sh_degree {sh_degree}")
    if not 0 <= sh_degree <= 3:
        raise ValueError(f"shade_composite_buffers: sh_degree {sh_degree} not in 0..3")
    if k > MAX_SHELLS:
        raise ValueError(f"shade_composite_buffers: {k} shells, K4 takes at most {MAX_SHELLS}")
    if width < 0 or (width > 0 and N % width != 0):
        raise ValueError(f"shade_composite_buffers: {N} rays are no frame of width {width}")
    rgb = torch.empty(N, 3, dtype=torch.float32, device=dev)
    bg_T = torch.empty(N, 1, dtype=torch.float32, device=dev)
    status = _build.kernels().vs_shade_composite(
        tri.data_ptr(), u.data_ptr(), v.data_ptr(), face_uv.data_ptr(), face_offsets.data_ptr(),
        rays_d.data_ptr(), tex.texels.data_ptr(), tex.kernel_table.data_ptr(),
        ignore_alpha.data_ptr(), bg_color.data_ptr(), k, sh_degree, N, width, rgb.data_ptr(),
        bg_T.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(status, "shade_composite_buffers")
    launches["shade"] += 1
    return {"rgb": rgb, "bg_transmittance": bg_T}


def half_ops_check(a, b):
    """K4's float16 arithmetic on the card, for its test: a, b float16 [n]
    CUDA tensors (n even). Returns (native, rounded, texel): native [6, n]
    the half2 and half _rn products, sums and differences of a and b;
    rounded [3, n] the float32 product, sum and difference rounded to
    float16; texel [4, n] the products of b with bytes 0-3 of the word
    a * 0x01010101 (a as an integer, clamped to 0-255) as K4 forms them
    from a texel word. All float16."""
    if not (a.is_cuda and a.dtype == b.dtype == torch.float16 and a.shape == b.shape
            and a.ndim == 1 and a.shape[0] % 2 == 0 and a.is_contiguous() and b.is_contiguous()):
        raise ValueError("half_ops_check: a, b must be contiguous float16 [n] CUDA tensors, n even")
    n = a.shape[0]
    out = torch.empty(13, n, dtype=torch.float16, device=a.device)
    _build.check(_build.kernels().vs_half_ops_check(
        a.data_ptr(), b.data_ptr(), n, out.data_ptr(),
        torch.cuda.current_stream(a.device).cuda_stream), "half_ops_check")
    return out[:6], out[6:9], out[9:]
