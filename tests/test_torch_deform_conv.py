"""Port DCNv2 vs the JAX package's ``impl="patch"`` on the CPU, with offsets
that send samples out of bounds. Bar: atol 2e-5 (fp32 sums over K*Cin
terms taken in another order)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from stif_tpu.nn.dcn import DCNSep as JDCNSep
from stif_tpu.ops.deform_conv import deform_conv2d as j_deform_conv2d
from stif_tpu.ops.deform_conv import split_offset_mask as j_split_offset_mask

from stif_tpu_torch.nn import DCNSep
from stif_tpu_torch.ops import deform_conv2d, split_offset_mask
from torch_parity import load_into_port, random_params, t

ATOL = 2e-5


def test_split_offset_mask(rng):
    G, K = 4, 9
    raw = rng.standard_normal((2, 5, 6, 3 * G * K)).astype(np.float32)
    want_o, want_m = j_split_offset_mask(jnp.asarray(raw), G, 3)
    got_o, got_m = split_offset_mask(t(raw), G, 3)
    assert got_o.shape == (2, 5, 6, G, K, 2)
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=1e-6)


@pytest.mark.parametrize("G,cin,stride,dilation", [
    (4, 16, 1, 1),
    (8, 32, 1, 1),
    (8, 16, 2, 1),
    (4, 8, 1, 2),
])
def test_deform_conv2d(rng, G, cin, stride, dilation):
    B, H, W, cout, k, pad = 2, 7, 9, 12, 3, 1
    Ho = (H + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    Wo = (W + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    # offsets up to +-6 px on a 7x9 map: many taps land outside the image
    offset = rng.uniform(-6, 6, (B, Ho, Wo, G, k * k, 2)).astype(np.float32)
    mask = rng.random((B, Ho, Wo, G, k * k)).astype(np.float32)
    w_hwio = rng.standard_normal((k, k, cin, cout)).astype(np.float32) * 0.1
    bias = rng.standard_normal(cout).astype(np.float32)
    want = np.asarray(j_deform_conv2d(
        jnp.asarray(x), jnp.asarray(offset), jnp.asarray(mask),
        jnp.asarray(w_hwio), jnp.asarray(bias), stride=stride, padding=pad,
        dilation=dilation, impl="patch"))
    got = deform_conv2d(t(x), t(offset), t(mask),
                        t(w_hwio.transpose(3, 2, 0, 1)), t(bias),
                        stride=stride, padding=pad, dilation=dilation).numpy()
    assert got.shape == want.shape == (B, Ho, Wo, cout)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("G", [4, 8])
def test_dcn_sep(rng, G):
    """DCNSep with a perturbed (non-zero) conv_offset_mask."""
    nf = 16
    jm = JDCNSep(nf, deformable_groups=G)
    x = rng.standard_normal((1, 8, 10, nf)).astype(np.float32)
    fea = rng.standard_normal((1, 8, 10, nf)).astype(np.float32)
    params = random_params(jm, jnp.asarray(x), jnp.asarray(fea), seed=G)
    assert np.abs(params["params"]["conv_offset_mask"]["kernel"]).max() > 0
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x),
                                        jnp.asarray(fea)))
    pm = load_into_port(DCNSep(nf, nf, deformable_groups=G), params)
    got = pm(t(x), t(fea)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
