"""The port's CUDA kernels against their plain PyTorch twins, on a GPU.

Every test here needs a CUDA device and nvcc, carries the `cuda` marker and
skips without a device.  The file imports no JAX, so it runs on a machine
that has only PyTorch (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerances: O is bf16 (2^-8 relative) and the kernel rounds P to bf16 for
the P.V product, so O gets atol/rtol 2e-2; the LSE is f32 from exact bf16
products summed in f32, so it gets atol 1e-3.
"""
import pytest
import torch

from vla_rft_tpu_torch.models.transformer import Decoder, TransformerConfig
from vla_rft_tpu_torch.models.factory import init_random_
from vla_rft_tpu_torch.ops import attention as tattn


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


KERNEL_CASES = [
    # (B, Sq, Sk, causal, per-row kwargs)
    (1, 352, 352, True, {}),
    (4, 352, 352, True, {"kv_lens": [352, 300, 200, 97]}),
    (2, 608, 608, True, {"kv_starts": [0, 37]}),
    (2, 100, 352, True, {"q_offset": [252, 252]}),
    (2, 352, 352, False, {"kv_lens": [352, 0]}),
    (1, 61, 130, False, {}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("B,Sq,Sk,causal,kw", KERNEL_CASES)
def test_flash_kernel_matches_plain_twin(cuda_device, B, Sq, Sk, causal, kw, D):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(B, Sq, 14, D, generator=gen, device=cuda_device).bfloat16()
    k = torch.randn(B, Sk, 2, D, generator=gen, device=cuda_device).bfloat16()
    v = torch.randn(B, Sk, 2, D, generator=gen, device=cuda_device).bfloat16()
    args = {k_: torch.tensor(v_, device=cuda_device) for k_, v_ in kw.items()}
    before = tattn.launches
    o, lse = tattn.flash_fwd(q, k, v, causal=causal, **args)
    torch.cuda.synchronize()
    assert tattn.launches == before + 1
    o_ref, lse_ref = tattn.attention_plain(q, k, v, causal=causal, return_lse=True, **args)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    q = torch.zeros(1, 8, 4, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        tattn.flash_fwd(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="head dim"):
        tattn.flash_fwd(q[..., :32].contiguous(), q[..., :32].contiguous(),
                        q[..., :32].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        tattn.flash_fwd(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))


@pytest.mark.cuda
def test_decoder_kernel_path_matches_plain_path(cuda_device):
    cfg = TransformerConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                            num_layers=2, num_heads=4, num_kv_heads=2, qkv_bias=True,
                            tie_word_embeddings=True)  # bf16, head dim 64
    with torch.device(cuda_device):
        dec = init_random_(Decoder(cfg), seed=0)
    ids = torch.randint(0, 512, (2, 96), device=cuda_device,
                        generator=torch.Generator(device=cuda_device).manual_seed(1))
    kv_lens = torch.tensor([96, 70], device=cuda_device)
    before = tattn.launches
    with torch.no_grad():
        _, h_kernel = dec(ids, kv_lens=kv_lens, compute_logits=False)
        assert tattn.launches == before + cfg.num_layers
        dec.attn_impl = "plain"
        _, h_plain = dec(ids, kv_lens=kv_lens, compute_logits=False)
    assert tattn.launches == before + cfg.num_layers
    scale = h_plain.float().abs().max()
    assert ((h_kernel.float() - h_plain.float()).abs().max() / scale) < 2e-2
