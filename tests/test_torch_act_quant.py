"""LayerNorm->int8 (K4) and QuickGELU->int8 (K5) of the PyTorch port.

The plain versions are held against the JAX Pallas kernels
``layer_norm_int8`` / ``quick_gelu_int8`` run in interpret mode, with the
JAX package's own tolerances (``tests/test_models.py::
test_act_quant_kernels_interpret``): scales within rtol 1e-5, dequantized
values within 1.01 x the largest scale, and codes that differ by at most 1
(the f32 sums are taken in another order, so a value on a rounding
boundary may fall to the neighbouring code). (2, 300, 256) needs row
padding on the TPU; the port pads nothing. The CUDA kernels against the
plain versions run only where there is a card (marker ``cuda``); that
machine has no JAX, so JAX comes in through a fixture and this file runs
there with ``python -m pytest --noconftest -m cuda tests/test_torch_act_quant.py``.
"""

import types

import numpy as np
import pytest
import torch
from torch import nn

from helping_hand_for_egocentric_videos_torch.ops import act_quant as aq


@pytest.fixture(scope="module")
def jx():
    jnp = pytest.importorskip("jax.numpy")
    from helping_hand_for_egocentric_videos_tpu.ops import act_quant

    return types.SimpleNamespace(jnp=jnp, aq=act_quant)


def _inputs(m, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, m, d)).astype(np.float32)
    g = (1.0 + 0.2 * rng.normal(size=(d,))).astype(np.float32)
    b = (0.1 * rng.normal(size=(d,))).astype(np.float32)
    ln = nn.LayerNorm(d)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(g))
        ln.bias.copy_(torch.from_numpy(b))
    return x, g, b, ln


def _assert_quant_close(got, want):
    (q, s), (wq, ws) = got, want
    q, s, wq, ws = (np.asarray(z) for z in (q, s, wq, ws))
    assert q.dtype == np.int8 and s.dtype == np.float32 and s.shape == q.shape[:-1] + (1,)
    np.testing.assert_allclose(s, ws, rtol=1e-5)
    assert np.abs(q.astype(np.int32) - wq.astype(np.int32)).max() <= 1
    np.testing.assert_allclose(q.astype(np.float32) * s, wq.astype(np.float32) * ws,
                               atol=1.01 * ws.max())


@pytest.mark.parametrize("m, d", [(7, 128), (300, 256)])
def test_layer_norm_int8_ref_matches_jax_interpret(jx, m, d):
    x, g, b, ln = _inputs(m, d)
    want = jx.aq.layer_norm_int8({"g": jx.jnp.asarray(g), "b": jx.jnp.asarray(b)},
                                 jx.jnp.asarray(x), 1e-6, interpret=True)
    got = aq.layer_norm_int8_ref(ln, torch.from_numpy(x), 1e-6)
    _assert_quant_close((got[0].numpy(), got[1].numpy()), want)


@pytest.mark.parametrize("m, d", [(7, 128), (300, 256)])
def test_quick_gelu_int8_ref_matches_jax_interpret(jx, m, d):
    x, *_ = _inputs(m, d, seed=1)
    want = jx.aq.quick_gelu_int8(jx.jnp.asarray(x), interpret=True)
    got = aq.quick_gelu_int8_ref(torch.from_numpy(x))
    _assert_quant_close((got[0].numpy(), got[1].numpy()), want)


def test_quantize_rows_ref_rounds_half_to_even():
    """The JAX rule rounds halves to even (jnp.round); a kernel that used
    C's roundf would round them away from zero."""
    y = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 0.0]])
    q, s = aq.quantize_rows_ref(y)
    assert s.item() == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, 0]]
    zq, zs = aq.quantize_rows_ref(torch.zeros(1, 4))  # the 1e-8 floor
    assert zq.abs().max().item() == 0 and zs.item() == pytest.approx(1e-8)


def test_wrappers_on_cpu_are_the_plain_versions_and_count_nothing():
    x, _, _, ln = _inputs(5, 64, seed=2)
    xt = torch.from_numpy(x)
    before = (aq.layer_norm_int8.launches, aq.quick_gelu_int8.launches)
    for got, want in (
        (aq.layer_norm_int8(ln, xt, 1e-6), aq.layer_norm_int8_ref(ln, xt, 1e-6)),
        (aq.quick_gelu_int8(xt), aq.quick_gelu_int8_ref(xt)),
    ):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (aq.layer_norm_int8.launches, aq.quick_gelu_int8.launches) == before


def test_wrappers_reject_other_devices():
    x = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="no layer_norm_int8 kernel"):
        aq.layer_norm_int8(nn.LayerNorm(8), x)
    with pytest.raises(ValueError, match="no quick_gelu_int8 kernel"):
        aq.quick_gelu_int8(x)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc "
                    "(python -m pytest --noconftest -m cuda tests/test_torch_act_quant.py)")
    return torch.device("cuda")


def _assert_kernel_close(got, want):
    """Kernel vs plain on the card: scales rtol 1e-5, codes within 1, and
    at most 0.1% of the codes differ at all."""
    (q, s), (wq, ws) = got, want
    torch.testing.assert_close(s, ws, rtol=1e-5, atol=0)
    diff = (q.int() - wq.int()).abs()
    assert diff.max().item() <= 1
    assert diff.count_nonzero().item() <= 1e-3 * diff.numel()


# (rows, D): fewer rows than the 8 warps of a K4 block and ragged tails
# (1, 3, 9, 33); the model's D = 1024; 768 (3 chunks a lane); 1000 (125
# chunks of bf16: the last lanes hold fewer); 100 (bf16: not a whole number
# of 16-byte chunks) and 4096 (K4's block route); 2048 (the widest row of
# its warp route)
ROWS_D = [(7, 128), (600, 100), (3, 1000), (4096, 1024), (512, 4096), (1, 1024), (3, 768),
          (9, 100), (33, 4096), (33, 2048), (9, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows, d", ROWS_D)
def test_cuda_kernels_match_plain(cuda_device, rows, d, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(rows, d, generator=gen, device=cuda_device).to(dt)
    ln = nn.LayerNorm(d, device=cuda_device)
    with torch.no_grad():
        ln.weight.copy_(1.0 + 0.2 * torch.randn(d, generator=gen, device=cuda_device))
        ln.bias.copy_(0.1 * torch.randn(d, generator=gen, device=cuda_device))
    before = (aq.layer_norm_int8.launches, aq.quick_gelu_int8.launches)
    got_ln, got_g = aq.layer_norm_int8(ln, x, 1e-6), aq.quick_gelu_int8(x)
    torch.cuda.synchronize()
    assert (aq.layer_norm_int8.launches, aq.quick_gelu_int8.launches) == (before[0] + 1, before[1] + 1)
    _assert_kernel_close(got_ln, aq.layer_norm_int8_ref(ln, x, 1e-6))
    _assert_kernel_close(got_g, aq.quick_gelu_int8_ref(x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1024, 100, 4096])
def test_cuda_layer_norm_int8_edge_rows(cuda_device, d, dtype):
    """K4 on rows of zeros (with beta 0 the output is 0 and the scale the
    1e-8 floor) and on rows with a mean of 32 and unit spread (a one-pass
    variance E[x^2] - E[x]^2 would lose 3 of f32's 7 digits of it), and
    on rows that start off a 16-byte boundary (K4 then takes its block
    route), against the plain version."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(17, d, generator=gen, device=cuda_device)
    x[0] = 0.0
    x[1:9] += 32.0
    x = x.to(dt)
    ln = nn.LayerNorm(d, device=cuda_device)
    with torch.no_grad():
        ln.weight.copy_(1.0 + 0.2 * torch.randn(d, generator=gen, device=cuda_device))
        ln.bias.zero_()
    got = aq.layer_norm_int8(ln, x, 1e-6)
    want = aq.layer_norm_int8_ref(ln, x, 1e-6)
    torch.cuda.synchronize()
    assert got[1][0].item() == pytest.approx(1e-8) and got[0][0].abs().max().item() == 0
    _assert_kernel_close(got, want)
    flat = torch.randn(16 * d + 1, generator=gen, device=cuda_device).to(dt)
    off = flat[1:].view(16, d)  # one element past the allocation's start
    _assert_kernel_close(aq.layer_norm_int8(ln, off, 1e-6), aq.layer_norm_int8_ref(ln, off, 1e-6))


@pytest.mark.cuda
def test_cuda_kernels_refuse_activations_that_require_grad(cuda_device):
    """No backward: an activation that requires grad raises with grad mode
    on; the LayerNorm's own parameters are read as constants, as the plain
    version reads them."""
    x = torch.randn(8, 256, device=cuda_device).requires_grad_()
    ln = nn.LayerNorm(256, device=cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        aq.layer_norm_int8(ln, x, 1e-6)
    with pytest.raises(RuntimeError, match="no backward"):
        aq.quick_gelu_int8(x)
    aq.layer_norm_int8(ln, x.detach(), 1e-6)
    with torch.no_grad():
        aq.quick_gelu_int8(x)
