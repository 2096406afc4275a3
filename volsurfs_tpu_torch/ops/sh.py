"""Real spherical harmonics basis (degrees 0-4) and evaluation.

Counterpart of volsurfs_tpu/ops/sh.py: the same hardcoded real-SH
polynomials, evaluated in the dtype of the inputs (float16 on the neural
texture path).
"""

from __future__ import annotations

import functools

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


@functools.lru_cache(maxsize=None)
def _constants(dtype):
    """(C0, C1, C2, C3, C4) rounded to dtype."""

    def r(c):
        return torch.tensor(c, dtype=dtype).item()

    return r(C0), r(C1), tuple(map(r, C2)), tuple(map(r, C3)), tuple(map(r, C4))


def sh_basis(dirs, degree: int):
    """SH basis values for unit directions.

    Args:
      dirs: [..., 3] unit directions.
      degree: 0-4.
    Returns: [..., (degree+1)^2] in the dtype of dirs. The constants are
    rounded to that dtype first, as JAX rounds weakly typed constants.
    """
    if not 0 <= degree <= 4:
        raise ValueError(f"degree must be in 0..4, got {degree}")
    C0, C1, C2, C3, C4 = _constants(dirs.dtype)
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ones = torch.ones_like(x)
    comps = [C0 * ones]
    if degree > 0:
        comps += [-C1 * y, C1 * z, -C1 * x]
    if degree > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        comps += [
            C2[0] * xy,
            C2[1] * yz,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * xz,
            C2[4] * (xx - yy),
        ]
    if degree > 2:
        comps += [
            C3[0] * y * (3 * xx - yy),
            C3[1] * xy * z,
            C3[2] * y * (4 * zz - xx - yy),
            C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            C3[4] * x * (4 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3 * yy),
        ]
    if degree > 3:
        comps += [
            C4[0] * xy * (xx - yy),
            C4[1] * yz * (3 * xx - yy),
            C4[2] * xy * (7 * zz - 1),
            C4[3] * yz * (7 * zz - 3),
            C4[4] * (zz * (35 * zz - 30) + 3),
            C4[5] * xz * (7 * zz - 3),
            C4[6] * (xx - yy) * (7 * zz - 1),
            C4[7] * xz * (xx - 3 * yy),
            C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    return torch.stack(comps, dim=-1)


def sh_eval(sh_coeffs, dirs, degree: int):
    """Evaluate SH coefficients at unit directions.

    Args:
      sh_coeffs: [..., C, (degree+1)^2] per-channel coefficients.
      dirs: [..., 3] unit directions.
    Returns: [..., C] in the dtype of sh_coeffs. The contraction takes
    products and sums in float32 and rounds once, as a float16 dot does.
    """
    basis = sh_basis(dirs, degree)  # [..., B]
    out = torch.sum(sh_coeffs.float() * basis.float()[..., None, :], dim=-1)
    return out.to(sh_coeffs.dtype)
