"""Parity of the torch port's neural textures with volsurfs_tpu's:
HashGrid2D forward and table gradient, SHNeuralTextures output."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volsurfs_tpu.models import encodings as JE
from volsurfs_tpu.models import textures as JT
from volsurfs_tpu_torch.convert import module_state_from_flax
from volsurfs_tpu_torch.models import textures as TT
from volsurfs_tpu_torch.models.encodings import _level_layout

torch.set_num_threads(2)


def _randomize(tree, rng, table_scale=0.5, weight_scale=0.3):
    """Replace flax params by numpy draws large enough that the outputs vary
    (the default init gives near-constant textures)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng, table_scale, weight_scale)
        elif k == "table":
            out[k] = rng.uniform(-table_scale, table_scale, v.shape).astype(np.float32)
        else:
            out[k] = (weight_scale * rng.standard_normal(v.shape)).astype(np.float32)
    return out


def test_level_layout_matches_jax():
    sizes = TT.HashGrid2D().sizes
    offsets, total_rows = _level_layout(sizes)
    ref_offsets, ref_total_rows = JE._level_layout(sizes)[:2]
    np.testing.assert_array_equal(offsets, ref_offsets)
    assert total_rows == ref_total_rows


def test_hashgrid2d_forward_and_table_grad_match_jax():
    rng = np.random.default_rng(0)
    # include uvs outside [0, 1]: negative corners exercise the uint32 wrap
    uv = rng.uniform(-0.1, 1.1, (500, 2)).astype(np.float32)
    cot = rng.standard_normal((500, 32)).astype(np.float32)
    jmod = JT.HashGrid2D()
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(uv[:4]))
    params = {"params": _randomize(jax.tree_util.tree_map(np.asarray, params["params"]), rng)}

    prev = JE._TABLE_GRAD_MODE
    JE.set_table_grad_mode("flat")  # exact f32 scatter on the JAX side
    try:
        ref_feats, vjp = jax.vjp(lambda p: jmod.apply(p, jnp.asarray(uv)), params)
        (ref_grad,) = vjp(jnp.asarray(cot))
        ref_grad = np.asarray(ref_grad["params"]["table"])
    finally:
        JE.set_table_grad_mode(prev)

    tmod = TT.HashGrid2D()
    tmod.load_state_dict(module_state_from_flax(params))
    feats = tmod(torch.from_numpy(uv))
    np.testing.assert_allclose(feats.detach().numpy(), np.asarray(ref_feats), atol=1e-6, rtol=0)
    feats.backward(torch.from_numpy(cot))
    grad = tmod.table.grad.numpy()
    assert np.count_nonzero(ref_grad) > 1000
    np.testing.assert_allclose(grad, ref_grad, rtol=1e-5, atol=0)


@pytest.mark.parametrize("quantize", [False, True])
def test_sh_neural_textures_match_jax(quantize):
    """Lerp sampling at res 64 with squeeze, with and without quantisation;
    float16 casts in the same places. atol 2e-3: one float16 ulp of the
    |x| <= 2 values before the final sigmoid."""
    rng = np.random.default_rng(1)
    n = 256
    uv = rng.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    dirs = rng.standard_normal((n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    kw = dict(
        sh_deg=3, nr_channels=3, sh_range=(1.0, 1.0, 1.0, 1.0),
        deg_res=(64, 64, 64, 64), lerp=True, squeeze_output=True,
        quantize_output=quantize,
    )
    jmod = JT.SHNeuralTextures(**kw)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(uv[:8]), jnp.asarray(dirs[:8]))
    params = {"params": _randomize(
        jax.tree_util.tree_map(np.asarray, params["params"]), rng, 0.5, 0.2
    )}
    ref = np.asarray(jmod.apply(params, jnp.asarray(uv), jnp.asarray(dirs)))

    tmod = TT.SHNeuralTextures(**kw)
    tmod.load_state_dict(module_state_from_flax(params))
    with torch.no_grad():
        out = tmod(torch.from_numpy(uv), torch.from_numpy(dirs)).numpy()
    assert out.shape == ref.shape == (n, 3)
    assert ref.std() > 0.01  # the textures are not constant
    np.testing.assert_allclose(out, ref, atol=2e-3, rtol=0)


@pytest.mark.parametrize("mode", ["bake", "anchor", "lerp"])
def test_neural_texture_modes_match_jax(mode):
    """One NeuralTexture (res 64, squeeze + quantise) in each sampling mode."""
    rng = np.random.default_rng(6)
    uv = rng.uniform(0.0, 1.0, (300, 2)).astype(np.float32)
    kw = dict(
        res=(64, 64), nr_channels=3, val_range=(-1.0, 1.0), anchor=mode == "anchor",
        lerp=mode == "lerp", quantize_output=True, squeeze_output=True,
    )
    jmod = JT.NeuralTexture(**kw)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(uv[:4]), True)
    params = {"params": _randomize(
        jax.tree_util.tree_map(np.asarray, params["params"]), rng, 0.5, 0.2
    )}
    ref = np.asarray(jmod.apply(params, jnp.asarray(uv), mode == "bake"))
    tmod = TT.NeuralTexture(**kw)
    tmod.load_state_dict(module_state_from_flax(params))
    with torch.no_grad():
        out = tmod(torch.from_numpy(uv), mode == "bake").numpy()
    assert out.shape == ref.shape == (300, 3)
    assert ref.std() > 0.01
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_round_ste_passes_gradient_through():
    x = torch.tensor([0.2, 1.5, 2.5, -0.7], requires_grad=True)
    y = TT.round_ste(x)
    np.testing.assert_array_equal(y.detach().numpy(), np.round([0.2, 1.5, 2.5, -0.7]))
    y.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(4))


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_sh_basis_and_eval_match_jax(dtype):
    """Degrees 0-4 in float32 (1e-6), and the float16 path of the textures
    (degree 0-1 terms bit for bit, the rest within one float16 ulp)."""
    from volsurfs_tpu.ops import sh as JS
    from volsurfs_tpu_torch.ops import sh as TS

    rng = np.random.default_rng(4)
    d = rng.standard_normal((1000, 3)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(dtype)
    c = rng.uniform(-1.0, 1.0, (1000, 3, 16)).astype(dtype)
    degree = 4 if dtype == np.float32 else 3
    ref = np.asarray(JS.sh_basis(jnp.asarray(d), degree)).astype(np.float32)
    out = TS.sh_basis(torch.from_numpy(d), degree).float().numpy()
    if dtype == np.float32:
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(out[:, :4], ref[:, :4])
        np.testing.assert_allclose(out, ref, atol=2e-3, rtol=0)
    ref_e = np.asarray(JS.sh_eval(jnp.asarray(c), jnp.asarray(d), 3)).astype(np.float32)
    out_e = TS.sh_eval(torch.from_numpy(c), torch.from_numpy(d), 3).float().numpy()
    np.testing.assert_allclose(out_e, ref_e, atol=1e-5 if dtype == np.float32 else 4e-3, rtol=0)
