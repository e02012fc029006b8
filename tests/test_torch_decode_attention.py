"""The narrator's decode attention (``ops/decode_attention.py``, K8).

On the CPU: the route keeps ``F.scaled_dot_product_attention`` there, in
f32 and bf16 (the same bits as the call it replaced), and the plain versions of
the kernel's order of work (an online softmax over key steps; the cross
mode's interleaved tile streams merged at the end) equal SDPA in f32 at
the narrator's head count and width, within ``F32`` (1e-5: the same
arithmetic in another order).

On the card (``cuda``): the kernel against an f32 SDPA and against the
bf16 SDPA it replaces, at the narrator's shapes (640 sequences x 25 heads
over 1, 2, 33 and 77 positions, the query a strided view of ``c_attn``'s
output as in ``models/gpt2.py``; 64 clips x 10 rows over 256 latents):
its relative gap to f32 is no larger than SDPA's, and it is within one
bf16 rounding of its plain version. Same inputs, same bits. The wrappers
and the route raise on what the kernel does not take (f32, another head
width): on the card nothing drops back to SDPA.
"""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from helping_hand_for_egocentric_videos_torch.ops import decode_attention as da

F32 = dict(rtol=1e-5, atol=1e-5)
H, DH, S = 25, 64, 77


def _self_inputs(n: int, dtype, device="cpu", seed: int = 0):
    """q as ``_self_attend`` has it (a view of (N, 3, H, dh) rows), the
    (N, H, S, dh) keys and values as ``cache.kv[i, 0 / 1]``."""
    g = torch.Generator(device).manual_seed(seed)
    qkv = torch.randn(n, 3 * H * DH, generator=g, device=device).to(dtype)
    q = qkv.view(n, 3, H, DH).unbind(1)[0]
    kv = torch.randn(2, n, H, S, DH, generator=g, device=device).to(dtype)
    return q, kv[0], kv[1]


def _cross_inputs(clips: int, r: int, m: int, dtype, device="cpu", seed: int = 1):
    g = torch.Generator(device).manual_seed(seed)
    q = torch.randn(clips * r, H * DH, generator=g, device=device).to(dtype).view(clips * r, H, DH)
    kv = torch.randn(2, clips, H, m, DH, generator=g, device=device).to(dtype)
    return q, kv[0], kv[1]


def _sdpa_self(q, k, v, keys):
    return F.scaled_dot_product_attention(q[:, :, None], k[:, :, :keys], v[:, :, :keys]).reshape(q.shape[0], -1)


def _sdpa_cross(q, k, v, r):
    n = q.shape[0]
    return F.scaled_dot_product_attention(q.view(n // r, r, H, DH).transpose(1, 2), k, v).transpose(1, 2).reshape(n, -1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_keeps_sdpa_off_the_card(dtype):
    before = da.launches()
    q, k, v = _self_inputs(4, dtype)
    assert torch.equal(da.self_attention(q, k, v, 33), _sdpa_self(q, k, v, 33))
    q, k, v = _cross_inputs(2, 3, 8, dtype)
    assert torch.equal(da.cross_attention(q, k, v, 3), _sdpa_cross(q, k, v, 3))
    assert da.launches() == before


@pytest.mark.parametrize("keys", [1, 2, 5, 33, 77])
def test_self_plain_version_is_sdpa_in_f32(keys):
    q, k, v = _self_inputs(16, torch.float32)
    torch.testing.assert_close(da.self_attention_ref(q, k, v, keys), _sdpa_self(q, k, v, keys), **F32)


@pytest.mark.parametrize("clips, r, m", [(4, 10, 256), (2, 3, 8), (3, 17, 70)])
def test_cross_plain_version_is_sdpa_in_f32(clips, r, m):
    q, k, v = _cross_inputs(clips, r, m, torch.float32)
    torch.testing.assert_close(da.cross_attention_ref(q, k, v, r), _sdpa_cross(q, k, v, r), **F32)


def test_wrappers_raise_off_the_card():
    q, k, v = _self_inputs(2, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_sdpa_self(q, k, v, 3)
    q, k, v = _cross_inputs(2, 3, 8, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_sdpa_cross(q, k, v, 3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (python -m pytest --noconftest -m cuda "
                    "tests/test_torch_decode_attention.py)")
    return torch.device("cuda")


def _gap(x, ref):
    return float((x.float() - ref).norm() / ref.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("keys", [1, 2, 33, 77])
def test_self_kernel_at_the_narrators_shape(cuda_device, keys):
    q, k, v = _self_inputs(640, torch.bfloat16, cuda_device, seed=keys)
    before = da.decode_sdpa_self.launches
    got = da.self_attention(q, k, v, keys)
    assert da.decode_sdpa_self.launches == before + 1
    assert got.shape == (640, H * DH) and got.dtype == torch.bfloat16
    f32 = _sdpa_self(q.float(), k.float(), v.float(), keys)
    assert _gap(got, f32) <= _gap(_sdpa_self(q, k, v, keys), f32)
    torch.testing.assert_close(got.float(), da.self_attention_ref(q, k, v, keys).float(), rtol=2 ** -7, atol=1e-5)
    assert torch.equal(da.self_attention(q, k, v, keys), got)


@pytest.mark.cuda
@pytest.mark.parametrize("clips, r, m", [(64, 10, 256), (3, 17, 70), (2, 1, 1)])
def test_cross_kernel_at_the_narrators_shape(cuda_device, clips, r, m):
    q, k, v = _cross_inputs(clips, r, m, torch.bfloat16, cuda_device)
    before = da.decode_sdpa_cross.launches
    got = da.cross_attention(q, k, v, r)
    assert da.decode_sdpa_cross.launches == before + 1
    assert got.shape == (clips * r, H * DH) and got.dtype == torch.bfloat16
    f32 = _sdpa_cross(q.float(), k.float(), v.float(), r)
    assert _gap(got, f32) <= _gap(_sdpa_cross(q, k, v, r), f32)
    torch.testing.assert_close(got.float(), da.cross_attention_ref(q, k, v, r).float(), rtol=2 ** -7, atol=1e-5)
    assert torch.equal(da.cross_attention(q, k, v, r), got)


@pytest.mark.cuda
def test_route_on_the_card_raises_where_the_kernel_does_not_take(cuda_device):
    before = da.launches()
    q, k, v = _self_inputs(8, torch.float32, cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        da.self_attention(q, k, v, 5)
    q, k, v = _cross_inputs(2, 3, 8, torch.float32, cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        da.cross_attention(q, k, v, 3)
    narrow = torch.randn(8, 4, 3, 32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="rows of 64"):
        da.self_attention(narrow[:, :, 0], narrow, narrow, 3)
    with pytest.raises(ValueError, match="rows of 64"):
        da.cross_attention(narrow[:, :, 0], narrow[:2], narrow[:2], 4)
    assert da.launches() == before


@pytest.mark.cuda
def test_wrappers_raise_on_what_they_do_not_take(cuda_device):
    q, k, v = _self_inputs(8, torch.bfloat16, cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        da.decode_sdpa_self(q.float(), k, v, 3)
    with pytest.raises(ValueError, match="keys"):
        da.decode_sdpa_self(q, k, v, S + 1)
    with pytest.raises(ValueError, match="keys"):
        da.decode_sdpa_self(q, k, v, 0)
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_sdpa_self(q, k.transpose(2, 3), v.transpose(2, 3), 3)
    with pytest.raises(ValueError, match="contiguous positions"):
        da.decode_sdpa_self(q, k[:, :, ::2], v[:, :, ::2], 3)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(8 * H * DH + 1, device=cuda_device, dtype=torch.bfloat16)
        da.decode_sdpa_self(flat[1:].view(8, H, DH), k, v, 3)
    with pytest.raises(ValueError, match="one layout"):
        da.decode_sdpa_self(q, k, v[:, :, :5], 3)
    narrow = torch.zeros(8, H, 32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="rows of 64"):
        da.decode_sdpa_self(narrow, k, v, 3)
    q, k, v = _cross_inputs(2, 3, 8, torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="clips x r"):
        da.decode_sdpa_cross(q, k, v, 2)
    wide = torch.zeros(2, 2, H, da.MAX_CROSS_KEYS + 1, DH, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous keys"):
        da.decode_sdpa_cross(q, wide[0], wide[1], 3)
    with pytest.raises(ValueError, match="one CUDA device"):
        da.decode_sdpa_cross(q, k.cpu(), v, 3)


@pytest.mark.cuda
def test_plans_name_one_wave_at_the_narrators_shape(cuda_device):
    self_plan = da.plan("self")
    assert self_plan["blocks_an_sm"] * self_plan["sms"] * self_plan["threads"] // 8 >= 640 * H
    assert da.plan("cross", 256)["blocks_an_sm"] >= 2
